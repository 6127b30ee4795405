"""Data of the port: a dataset registry and ``create_dataset``.

Port of ``nerfsr_tpu/data/__init__.py``. Each dataset gives a training
ray buffer (numpy, uploaded to the card once) and per-view rays or
device-raygen specs for eval. Ported: ``llff`` (``llff.py``),
``llff_downX`` (``llff_downx.py``), ``blender`` (``blender.py``),
``blender_downX`` (``blender_downx.py``), the refine stage's
``llff_refine`` (``refine.py``) and the template's pairs
(``template.py``); camera-geometry views in memory
(``views.py``); synthetic COLMAP and Blender scenes (``synthetic.py``).
"""

from nerfsr_torch import spans

DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


@spans.spanned("nerfsr.data.load")
def create_dataset(opt, mode: str):
    """``--dataset_mode`` -> dataset instance in ``mode``."""
    from nerfsr_torch.data import (blender, blender_downx,  # noqa: F401
                                   llff, llff_downx, refine,
                                   template)  # (they register)
    name = opt.dataset_mode
    if name not in DATASET_REGISTRY:
        raise KeyError(f"dataset {name!r} not found; available: "
                       f"{sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](opt, mode)
