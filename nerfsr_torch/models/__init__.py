"""Model registry of the port (``--model`` name -> system class)."""

from __future__ import annotations

_MODELS = {}

# the options no module of the port covers yet, each with its ROADMAP.md
# item: (test of opt, the option, the item)
UNPORTED = (
    (lambda opt: opt.model == "template", "--model template",
     "6, the template system"),
    (lambda opt: opt.mlp_network == "neutex_mlp",
     "--mlp_network neutex_mlp", "6, NeuTexMLP"),
)


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


def refuse_unported(opt):
    """Raise for an option that is not ported yet, naming its item."""
    for hit, what, item in UNPORTED:
        if hit(opt):
            raise unported(what, item)


def register_model(name):
    def deco(cls):
        _MODELS[name] = cls
        return cls
    return deco


def create_model(opt, device=None):
    """Build the system ``opt.model`` names, on ``device`` (default cuda;
    raises without a card unless ``device="cpu"``)."""
    refuse_unported(opt)
    # importing the modules registers them
    from nerfsr_torch.models import (nerf_downx_system,  # noqa: F401
                                     nerf_system, refine_system)
    if opt.model not in _MODELS:
        raise KeyError(f"model {opt.model!r} is not ported yet; ported: "
                       f"{sorted(_MODELS)}")
    return _MODELS[opt.model](opt, device=device)
