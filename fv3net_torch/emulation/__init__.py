"""In-physics emulation hooks (port of ``fv3net_tpu/emulation``;
reference: external/emulation): a ``MicrophysicsEmulator`` replaces the
Zhao-Carr scheme (or its gscond stage) inside the physics step, masks
gate which fields the emulator may overwrite, and a ``StorageHook``
captures physics-state snapshots for training data."""
from fv3net_torch.emulation.hooks import (  # noqa: F401
    IntervalSchedule,
    LevelMask,
    MicrophysicsEmulator,
    RangeMask,
    StorageHook,
    TimeMask,
    compose_masks,
    get_hooks,
)
