from repro_torch.data.har import (DATASETS, HARDataset, ModalityDef,
                                  client_batches, make_har_dataset,
                                  mm_config_for, synthesize_dataset)
from repro_torch.data.registry import (DatasetProvider, SyntheticProvider,
                                       get_provider, provider_names,
                                       register_provider)
from repro_torch.data.tokens import synthetic_token_batches
