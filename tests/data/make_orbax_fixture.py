"""Write ``tests/data/orbax_jax_fixture/``: an orbax checkpoint directory
as the JAX package writes one, for the port's reader where JAX is absent.

    python tests/data/make_orbax_fixture.py

The checkpoint holds ``{"train_state": ..., "big": ...}`` saved through
orbax's ``StandardCheckpointer``, as ``nerfsr_tpu.utils.checkpoint``
saves a state:

- ``train_state``: the JAX ``TrainState`` of NeRF-SR x2 (``OPTIONS``:
  ``--fast_preset llff``, D2/W16, ``--grad_clip_val`` and
  ``--fix_layers``, so it has the clip's empty state and frozen leaves'
  empty moments) after 3 Adam steps on gradients drawn from a seed;
- ``big``: a 256x160 f32 array (160 KiB) of bf16-rounded values, so that
  its zstd frame spans two blocks with Huffman-coded literals and
  FSE-coded sequences (the generator checks that it does).

``orbax_jax_fixture.json`` beside the directory lists each leaf's path,
shape, dtype and sha256, and ``OPTIONS``. ``tests/test_torch_orbax.py``
checks that ``build()`` still gives those digests and that the port
reads the directory to them; ``chip_smoke.py`` reads it with no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

FIXTURE = os.path.join(HERE, "orbax_jax_fixture")
DIGESTS = os.path.join(HERE, "orbax_jax_fixture.json")
OPTIONS = dict(model="nerf_downX", dataset_mode="llff_downX",
               fast_preset="llff", img_wh=[16, 12], downscale=2,
               precision="f32", D=2, W=16, n_epochs=4, n_epochs_decay=2,
               grad_clip_val=0.05, fix_layers="fine/params/xyz_encoding_1")
STEPS = 3


def build():
    """The pytree the fixture saves, as host arrays."""
    import jax
    import numpy as np
    import optax

    from nerfsr_tpu.config import default_options
    from nerfsr_tpu.models import create_model

    opt = default_options("train", **dict(OPTIONS,
                                          img_wh=tuple(OPTIONS["img_wh"])))
    system = create_model(opt)
    state = system.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    rng = np.random.RandomState(0)
    @jax.jit
    def adam_step(params, opt_state, grads):
        updates, opt_state = system.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = state.params, state.opt_state
    for _ in range(STEPS):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * 0.01).astype(np.float32),
            params)
        params, opt_state = adam_step(params, opt_state, grads)
    state = state.replace(step=state.step + STEPS, params=params,
                          opt_state=opt_state)
    big = (rng.randn(256, 160) * 0.02).astype(np.float32)
    big = (big.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return jax.device_get({"train_state": state, "big": big})


def leaves(tree):
    """{"a.b.c": array} of the pytree's array leaves, keyed as orbax names
    them."""
    import jax
    import numpy as np
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = ".".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out[key] = np.asarray(leaf)
    return out


def digests(tree) -> dict:
    return {k: {"shape": list(a.shape), "dtype": a.dtype.str,
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            for k, a in leaves(tree).items()}


def block_kinds(frame: bytes) -> list:
    """(block type, literals type, sequence modes byte or None) of each
    block of one zstd frame without a dictionary."""
    fhd, out = frame[4], []
    # magic, descriptor, window (multi-segment only), content size
    pos = 4 + 1 + (0 if fhd & 0x20 else 1) + {0: int(bool(fhd & 0x20)),
                                              1: 2, 2: 4, 3: 8}[fhd >> 6]
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        kind, size = (bh >> 1) & 3, bh >> 3
        body = frame[pos + 3:pos + 3 + size]
        lit, modes = None, None
        if kind == 2:
            lit = body[0] & 3
            sf = (body[0] >> 2) & 3
            if lit < 2:
                hsize = {0: 1, 1: 2, 2: 1, 3: 3}[sf]
                rsize = int.from_bytes(body[:hsize], "little") >> (
                    3 if sf in (0, 2) else 4)
                used = hsize + (rsize if lit == 0 else 1)
            else:
                hsize = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
                bits = {0: 10, 1: 10, 2: 14, 3: 18}[sf]
                h = int.from_bytes(body[:hsize], "little")
                used = hsize + ((h >> (4 + bits)) & ((1 << bits) - 1))
            nseq = body[used]
            step = 1 if nseq < 128 else 2 if nseq < 255 else 3
            modes = body[used + step] if nseq else None
        out.append((kind, lit, modes))
        pos += 3 + (1 if kind == 1 else size)
        if bh & 1:
            return out


def main():
    import orbax.checkpoint as ocp
    import tensorstore as ts

    tree = build()
    shutil.rmtree(FIXTURE, ignore_errors=True)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(FIXTURE, tree)
    ckptr.wait_until_finished()
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + FIXTURE + "/"}).result()
    kinds = block_kinds(kv.read(b"big/0.0").result().value)
    # at least two blocks, one with Huffman-coded literals (2) and an
    # FSE-coded table (mode 2) among its sequences' three
    assert len(kinds) >= 2 and any(
        kind == 2 and lit == 2 and modes is not None
        and 2 in ((modes >> 6) & 3, (modes >> 4) & 3, (modes >> 2) & 3)
        for kind, lit, modes in kinds), kinds
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 512 * 1024, size
    with open(DIGESTS, "w") as f:
        json.dump({"options": OPTIONS, "steps": STEPS,
                   "leaves": digests(tree)}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURE} ({size} bytes; big/0.0 blocks {kinds})")


if __name__ == "__main__":
    main()
