"""Schema-described synthetic datasets for tests.

reference: external/synth/synth/core.py:33-120 (Range / VariableSchema /
CoordinateSchema / DatasetSchema, deterministic generate, JSON
dump/load, read_schema_from_zarr) + canned generators
(synth/__init__.py:14-31) — minus the dask chunking layer, which this
framework does not need.
"""
from fv3net_torch.synth.core import (  # noqa: F401
    CoordinateSchema,
    DatasetSchema,
    Range,
    VariableSchema,
    dump,
    dumps,
    generate,
    load,
    loads,
    read_schema_from_dataset,
    read_schema_from_zarr,
)
from fv3net_torch.synth.cdl import cdl_to_dataset  # noqa: F401
from fv3net_torch.synth.generators import (  # noqa: F401
    generate_fine_res,
    generate_nudging,
    generate_restart_data,
)
