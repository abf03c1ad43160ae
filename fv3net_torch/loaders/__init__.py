"""Training-data access (port of ``fv3net_tpu/loaders``; reference:
external/loaders/loaders/__init__.py): time-keyed zarr mappers (nudged,
fine-res, high-res diagnostics, hybrid), stacked column batches, lazy
sequences and the registries of the yaml data configs.
"""
from fv3net_torch.loaders.batches import (  # noqa: F401
    ZarrMapper,
    batches_from_config,
    batches_from_mapper,
    batches_from_netcdf,
    stack_dataset,
)
from fv3net_torch.loaders.config import (  # noqa: F401
    BatchesConfig,
    BatchesFromMapperConfig,
    BatchesLoader,
    FunctionRegister,
    MapperConfig,
    batches_functions,
    mapper_functions,
)
from fv3net_torch.loaders.mappers import (  # noqa: F401
    Approach,
    GeoMapper,
    KeyMap,
    MergedMapper,
    MultiDatasetMapper,
    SubsetTimes,
    ValMap,
    open_fine_resolution,
    open_fine_resolution_nudging_hybrid,
    open_high_res_diags,
    open_nudge_to_fine,
    open_nudge_to_fine_multiple_datasets,
    open_nudge_to_fine_scream,
    open_nudge_to_obs,
)
from fv3net_torch.loaders.sequences import (  # noqa: F401
    Local,
    Map,
    OneAheadIterator,
    Take,
    shuffle,
    to_local,
)
from fv3net_torch.loaders.serialized import SerializedSequence  # noqa: F401

# the reference re-exports fv3fit's stacking util as ``loaders.stack``
from fv3net_torch.loaders.batches import stack_dataset as stack  # noqa: F401

SAMPLE_DIM_NAME = "sample"  # reference: loaders/constants.py
TIME_NAME = "time"
TIME_FMT = "%Y%m%d.%H%M%S"
DERIVATION_DIM = "derivation"
DATASET_DIM_NAME = "dataset"

# -- registry population (reference registers via decorators at def site;
# here registration is centralized so the modules stay import-light) ----
for _fn in (
    open_fine_resolution,
    open_fine_resolution_nudging_hybrid,
    open_high_res_diags,
    open_nudge_to_fine,
    open_nudge_to_fine_multiple_datasets,
    open_nudge_to_fine_scream,
    open_nudge_to_obs,
):
    mapper_functions.register(_fn)

batches_functions.register(batches_from_netcdf)
batches_functions.register(batches_from_mapper)
del _fn
