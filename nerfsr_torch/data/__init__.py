"""Data of the port: a dataset registry and ``create_dataset``.

Port of ``nerfsr_tpu/data/__init__.py``. Each dataset gives a grouped
training ray buffer (numpy, uploaded to the card once) and per-view rays
or device-raygen specs for eval. Ported: ``llff_downX``
(``llff_downx.py``); camera-geometry views in memory (``views.py``);
synthetic COLMAP scenes (``synthetic.py``).
"""

DATASET_REGISTRY = {}

# dataset modes the JAX package has and the port does not yet
_NOT_PORTED = {"llff", "blender", "blender_downX"}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def create_dataset(opt, mode: str):
    """``--dataset_mode`` -> dataset instance in ``mode``."""
    from nerfsr_torch.data import llff_downx  # noqa: F401  (registers)
    name = opt.dataset_mode
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md queue 1: the "
            "vanilla LLFF and Blender datasets)")
    if name not in DATASET_REGISTRY:
        raise KeyError(f"dataset {name!r} not found; available: "
                       f"{sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](opt, mode)
