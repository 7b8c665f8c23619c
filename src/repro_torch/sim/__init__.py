from repro_torch.sim.devices import (DEVICE_PROFILES, DeviceProfile,
                                     FleetConfig, make_fleet, scale_fleet)
from repro_torch.sim.events import AsyncTrace, EventQueue, completion_times
from repro_torch.sim.faults import CORRUPTIONS, FaultModel, FaultRuntime
from repro_torch.sim.fleet import (FleetState, PopulationModel,
                                   pack_group_bits, unpack_group_bits)
from repro_torch.sim.timing import RoundCost, cycle_times, simulate_round
