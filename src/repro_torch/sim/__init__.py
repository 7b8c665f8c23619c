from repro_torch.sim.devices import (DEVICE_PROFILES, DeviceProfile,
                                     FleetConfig, make_fleet, scale_fleet)
from repro_torch.sim.events import AsyncTrace, EventQueue, completion_times
from repro_torch.sim.faults import CORRUPTIONS, FaultModel, FaultRuntime
from repro_torch.sim.fleet import (FleetState, PopulationModel,
                                   pack_group_bits, unpack_group_bits)
from repro_torch.sim.scenarios import (MISSING_GENERATORS, SCENARIOS,
                                      Scenario, ScenarioSpec,
                                      StreamingSchedule, build_fleet,
                                      build_scenario, get_scenario, make_run,
                                      scenario_names, static_missing_mask,
                                      streaming_schedule,
                                      tiered_missing_mask)
from repro_torch.sim.timing import RoundCost, cycle_times, simulate_round
