"""The port's orbax checkpoint backend on the CPU, against zstandard,
tensorstore, orbax and the JAX package.

- the C zstd decoder (``nerfsr_torch/utils/zstd.py``) against
  ``zstandard``: levels 1, 3 and 19, content-size and checksum flags on
  and off, frames of several blocks (raw, RLE and compressed; Huffman
  literals in 1 and 4 streams and treeless; FSE tables predefined, RLE,
  compressed and repeated), the empty frame, two frames back to back, a
  skippable frame, and the errors; crc32c and xxhash64 against their
  references;
- the OCDBT reader (``nerfsr_torch/utils/ocdbt.py``) against tensorstore
  on directories the JAX package wrote and on a tree with interior nodes;
  the writer's stores listed and read by tensorstore's ``ocdbt`` driver;
- orbax directories both ways, bit for bit: the JAX package's
  ``TrainState`` (plain, ``--grad_clip_val``, ``--fix_layers``), the
  template's state and a ``RefineState`` into the port (and one more
  step of each side after the plain one), and the port's into
  ``nerfsr_tpu.utils.checkpoint.load_checkpoint``;
- the JAX package's resume rules (``tests/test_checkpoint.py``) in the
  port: a resume across a switch of backend, the multi-process fallback
  to msgpack, a torn msgpack giving way to its orbax sibling, ``latest``
  falling back, ``--init_weights`` from an orbax experiment, the save's
  copy and commit, and ``wait_for_saves`` re-raising a write error;
- the committed fixture ``tests/data/orbax_jax_fixture/`` against its
  generator's digests, and a round trip in an interpreter where jax,
  flax, orbax, tensorstore, zstandard and msgpack cannot be imported.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import flax.serialization as fs
import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)
import xxhash
import zstandard

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models.nerf_system import TrainState as JTrainState
from nerfsr_tpu.models.refine_system import RefineState as JRefineState
from nerfsr_tpu.utils import checkpoint as j_ckpt
from nerfsr_tpu.utils.schedule import make_jax_lr_schedule

from nerfsr_torch.config import default_options
from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils import hostlib, ocdbt, orbax, zstd
from nerfsr_torch.weights import (export_params, export_variables,
                                  flatten_tree)

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
sys.path.insert(0, str(DATA))
import make_orbax_fixture  # noqa: E402

HR_WH = (16, 12)
FOCAL = 14.0
# f32 updates of one Adam step from the same moments, per leaf,
# norm-relative (the bar of tests/test_torch_ckpt.py)
UPDATE_REL = 2e-2
VARIANTS = {"plain": {}, "clip": dict(grad_clip_val=0.05),
            "fix_layers": dict(fix_layers="fine/params/xyz_encoding_1")}
STATES = sorted(VARIANTS) + ["refine", "template"]


def _kw(name, tmp, **extra):
    """Options of state ``name``: NeRF-SR x2 at D4/W64, the refine UNet
    at ngf 8, or the template."""
    if name == "template":
        kw = dict(batch_size=64, lr=1e-2, n_epochs=3, n_epochs_decay=2)
    elif name == "refine":
        kw = dict(model="refine", dataset_mode="llff_refine", patch_len=32,
                  batch_size=2, num_ref_patches=2, ngf=8, num_downs=5,
                  n_epochs=1, n_epochs_decay=0, refine_with_l1=True)
    else:
        kw = dict(model="nerf_downX", dataset_mode="llff_downX",
                  fast_preset="llff", img_wh=HR_WH, downscale=2,
                  precision="f32", D=4, W=64, batch_size=48, n_epochs=4,
                  n_epochs_decay=2, randomized=False, noise_std=0.0,
                  **VARIANTS[name])
    kw.update(checkpoints_dir=str(tmp), name=name, **extra)
    return kw


def _port(name, tmp, **extra):
    opt = default_options("train", device="cpu", **_kw(name, tmp, **extra))
    system = create_model(opt, device="cpu")
    return opt, system, system.create_state(0, steps_per_epoch=4)


def _filled(tree, seed):
    """``tree`` with every float leaf drawn from ``seed`` (positive, so
    that Adam's second moments stay valid) and every integer leaf (the
    counts) 2: a state as after two steps, with no step compiled."""
    rng = np.random.RandomState(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.full(x.shape, 2, x.dtype)
        return jnp.asarray(np.abs(rng.randn(*x.shape) * 0.01).astype(
            x.dtype))
    return jax.tree_util.tree_map(fill, tree)


def _jax_state(name, tmp):
    """(JAX options, system, state) of ``name``, its weights and moments
    drawn and its counts at 2."""
    jopt = j_default_options("train", **_kw(name, tmp,
                                            ckpt_backend="orbax"))
    jsys = j_create_model(jopt)
    if name == "refine":
        # the port's variables, and the Adam chain RefineSystem builds
        _, system, _ = _port(name, tmp)
        variables = export_variables(system.build_net(seed=1))
        sched = make_jax_lr_schedule(jopt, 1)
        jsys.tx = optax.chain(
            optax.scale_by_adam(b1=jopt.beta1, b2=0.999),
            optax.scale_by_schedule(lambda s: -sched(s)))
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JRefineState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) + 0.5, variables["batch_stats"]),
            opt_state=jsys.tx.init(params))
    elif name == "template":
        state = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    else:
        # the port's initial weights, and the chain create_state builds
        # (no flax init to compile)
        _, _, port = _port(name, tmp)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        export_params(port.params))
        jsys._steps_per_epoch = 4
        jsys.tx = jsys._make_tx(params)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jsys.tx.init(params))
    return jopt, jsys, state.replace(
        step=state.step + 2, params=_filled(state.params, len(name)),
        opt_state=_filled(state.opt_state, len(name) + 1))


def _sd(state):
    return fs.to_state_dict(jax.tree_util.tree_map(np.asarray, state))


def _assert_sd_equal(got, want):
    """Two state dicts leaf for leaf, bit for bit, empty nodes too."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert got[k] == {}, k
            continue
        a, w = np.asarray(got[k]), np.asarray(w)
        assert a.dtype == w.dtype and a.shape == w.shape, k
        assert np.array_equal(a, w), k


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """Each state of ``STATES`` saved by the JAX package with
    ``--ckpt_backend orbax`` as epoch 1."""
    out = {}
    for name in STATES:
        tmp = tmp_path_factory.mktemp(name)
        jopt, jsys, state = _jax_state(name, tmp)
        path = j_ckpt.save_checkpoint(jopt, state, 1)
        out[name] = (jopt, jsys, state, path)
    j_ckpt.wait_for_saves()
    return out


# ---------------------------------------------------------------------
# zstd, crc32c, xxhash64
# ---------------------------------------------------------------------

def _corpus():
    """Payloads over 128 KiB (frames of several blocks) and small ones,
    each shaped to draw a kind of block or table from the encoder."""
    rng = np.random.RandomState(0)
    tokens = [rng.bytes(8) for _ in range(16)]
    base = rng.bytes(64)
    floats = (rng.randn(40000) * 1e-2).astype(np.float32)
    bf16 = ((rng.randn(40000) * 0.02).astype(np.float32).view(np.uint32)
            & 0xFFFF0000).view(np.float32)
    sparse = np.where(rng.rand(40000) < 0.05, rng.randn(40000), 0)
    return {
        "empty": b"", "text": b"the quick brown fox " * 80,
        "floats": floats.tobytes(), "bf16": bf16.tobytes(),
        "sparse": sparse.astype(np.float32).tobytes(),
        "zeros": bytes(140000), "random": rng.bytes(140000),
        "tokens": b"".join(tokens[i] for i in rng.randint(0, 16, 20000)),
        "runs": b"".join(bytes([int(rng.randint(0, 4))])
                         * int(rng.randint(4, 40)) for _ in range(8000)),
        "qq": b"".join(b"QQQ" + base[:int(rng.randint(8, 60))]
                       for _ in range(4000))}


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("content_size,checksum", [
    (True, True), (True, False), (False, True), (False, False)])
def test_zstd_decoder_matches_zstandard(corpus, level, content_size,
                                        checksum):
    comp = zstandard.ZstdCompressor(level=level,
                                    write_content_size=content_size,
                                    write_checksum=checksum)
    for name, data in corpus.items():
        if content_size:
            frame = comp.compress(data)
        else:                   # streamed: no size, the blocks as fed
            co = comp.compressobj()
            frame = (co.compress(data[:50000]) + co.compress(data[50000:])
                     + co.flush())
        assert bytes(zstd.decompress(frame)) == data, name


def test_zstd_corpus_covers_every_block_and_table_kind(corpus):
    """The corpus at the three levels holds raw, RLE and compressed
    blocks; raw, Huffman and treeless literals; and predefined,
    compressed and repeated tables for all three sequence codes (and RLE
    for the literal lengths)."""
    seen = set()
    for level in (1, 3, 19):
        comp = zstandard.ZstdCompressor(level=level)
        for data in corpus.values():
            for block, lit, modes in make_orbax_fixture.block_kinds(
                    comp.compress(data)):
                seen |= {("block", block), ("literals", lit)}
                if modes is not None:
                    seen |= {(code, (modes >> shift) & 3) for code, shift in
                             (("ll", 6), ("of", 4), ("ml", 2))}
    want = {("block", k) for k in (0, 1, 2)} | \
        {("literals", k) for k in (0, 2, 3)} | \
        {(code, m) for code in ("ll", "of", "ml") for m in (0, 2, 3)} | \
        {("ll", 1)}
    assert want <= seen, want - seen


def test_zstd_frames_back_to_back_raw_frames_and_errors(corpus):
    a, b = corpus["bf16"], corpus["text"]
    two = (zstandard.ZstdCompressor(level=3).compress(a)
           + b"\x50\x2a\x4d\x18\x03\x00\x00\x00xyz"       # skippable
           + zstandard.ZstdCompressor(level=19, write_checksum=True)
           .compress(b))
    assert bytes(zstd.decompress(two)) == a + b
    # the writer's raw frames, read by zstandard and by the port
    for n in (0, 1, 128 * 1024, 128 * 1024 + 1, 300000):
        data = corpus["random"][:n] if n <= 150000 else corpus["floats"][:n]
        frame = b"".join(bytes(p) for p in zstd.raw_frame_parts(data))
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert bytes(zstd.decompress(frame)) == data
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(corpus["text"]))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))
    good = zstandard.ZstdCompressor(level=3).compress(corpus["floats"])
    for bad, match in ((good[:len(good) // 2], "truncated"),
                       (b"\x00" * 16, "not a zstd frame")):
        with pytest.raises(ValueError, match=match):
            zstd.decompress(bad)
    samples = [bytes(corpus["tokens"][i:i + 64]) for i in range(0, 64000, 64)]
    dictionary = zstandard.train_dictionary(4096, samples)
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(zstandard.ZstdCompressor(
            dict_data=dictionary).compress(samples[0]))


def test_crc32c_and_xxhash64_match_their_references(corpus):
    assert zstd.crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"a", corpus["text"], corpus["random"][:1001]):
        crc = google_crc32c.value(data)
        assert zstd.crc32c(data) == crc
        assert zstd.crc32c(data[7:], zstd.crc32c(data[:7])) == crc
        assert zstd.xxh64(data) == xxhash.xxh64_intdigest(data)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "broken.c"
    src.write_text("int f( {\n")
    monkeypatch.setattr(hostlib, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(hostlib, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.c failed"):
        hostlib.build()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CC", raising=False)
    with pytest.raises(RuntimeError, match="no C compiler"):
        hostlib.build()


# ---------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------

def _tensorstore(root):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{root}/"}).result()


def _assert_store_equal(root):
    store, kv = ocdbt.Store(str(root)), _tensorstore(root)
    keys = kv.list().result()
    assert sorted(keys) == store.keys() and keys
    for k in keys:
        assert kv.read(k).result().value == store.get(k), k


@pytest.mark.parametrize("name", STATES)
def test_ocdbt_reader_matches_tensorstore_on_jax_dirs(jax_dirs, name):
    path = jax_dirs[name][3]
    _assert_store_equal(path)                      # the merged root
    _assert_store_equal(os.path.join(path, "ocdbt.process_0"))


def test_ocdbt_reader_walks_interior_nodes(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 500,
                                     "max_inline_value_bytes": 16}}
                         ).result()
    with ts.Transaction() as txn:
        for i in range(150):
            kv.with_transaction(txn)[f"key/{i:04d}/v"] = b"%d" % i * (i % 9)
    root = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()
                         ).result()["versions"][-1]
    assert root["root_height"] >= 2
    _assert_store_equal(tmp_path)


def test_ocdbt_writer_reads_through_tensorstore(tmp_path):
    rng = np.random.RandomState(1)
    items = {f"a.b{i}/{'x' * (i % 5)}": [rng.bytes(int(rng.randint(0,
                                                                     3000)))]
             for i in range(60)}
    items["big/0.0"] = [rng.bytes(200000), b"tail"]
    items["empty"] = [b""]
    ocdbt.write_store(str(tmp_path), items)
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_inline_value_bytes": 1024,
                   "max_decoded_node_bytes": 100_000_000,
                   "compression": {"id": "zstd"}}}).result()
    assert sorted(kv.list().result()) == sorted(k.encode() for k in items)
    for k, parts in items.items():
        assert kv.read(k).result().value == b"".join(parts), k
    _assert_store_equal(tmp_path)


# ---------------------------------------------------------------------
# orbax directories both ways
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", STATES)
def test_jax_orbax_checkpoint_loads_into_port(jax_dirs, name):
    jopt, _, jstate, path = jax_dirs[name]
    opt, _, state = _port(name, os.path.dirname(os.path.dirname(path)),
                          ckpt_backend="orbax")
    opt.name = os.path.basename(os.path.dirname(path))
    ckpt.load_checkpoint(opt, state, epoch=1)
    assert state.step == 2
    _assert_sd_equal(ckpt.state_dict(opt, state), _sd(jstate))
    _assert_sd_equal(orbax.restore(path), _sd(jstate))


def _views_batch(seed):
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(3, HR_WH[1], HR_WH[0], 3) * 255).astype(np.uint8)
    buf = LLFFDownXTrainViews(views.poses, imgs, FOCAL, HR_WH,
                              2).ray_buffer("cpu")
    n = (HR_WH[0] // 2) * (HR_WH[1] // 2)
    return {k: v[n:2 * n].numpy() for k, v in buf.items()}


def test_next_step_after_an_orbax_load_matches_jax(jax_dirs, tmp_path):
    jopt, jsys, jstate, path = jax_dirs["plain"]
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax")
    opt.checkpoints_dir = os.path.dirname(os.path.dirname(path))
    ckpt.load_checkpoint(opt, state, epoch=1)
    batch = _views_batch(5)
    old = [np.array(x) for x in jax.tree_util.tree_leaves(jstate.params)]
    # the step donates its state: give it a copy
    jnext, _ = jsys.train_step(jax.tree_util.tree_map(jnp.array, jstate),
                               batch, jax.random.PRNGKey(9))
    state, _ = system.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == int(jnext.step) == 3
    got = jax.tree_util.tree_leaves(ckpt.state_dict(opt, state)["params"])
    for a, b, o in zip(got, jax.tree_util.tree_leaves(jnext.params), old):
        ua, ub = a - o, np.asarray(b) - o
        assert np.linalg.norm(ua - ub) <= UPDATE_REL * np.linalg.norm(ub)


@pytest.mark.parametrize("name", STATES)
def test_port_orbax_checkpoint_restores_in_jax(jax_dirs, name, tmp_path):
    jopt, _, jstate, _ = jax_dirs[name]
    opt, _, state = _port(name, tmp_path, ckpt_backend="orbax")
    ckpt.load_state_dict(opt, state, _sd(jstate))
    with torch.no_grad():             # move every tensor off JAX's values
        for t in list(state_tensors(state)):
            t.add_(torch.randn_like(t) * 1e-3)
    path = ckpt.save_checkpoint(opt, state, 1)
    ckpt.wait_for_saves()
    mine = ckpt.state_dict(opt, state)
    jopt.checkpoints_dir = str(tmp_path)
    restored = j_ckpt.load_checkpoint(jopt, jstate, epoch=1)
    _assert_sd_equal(mine, _sd(restored))
    _assert_store_equal(path)
    latest = j_ckpt.load_checkpoint(jopt, jstate, epoch="latest")
    _assert_sd_equal(mine, _sd(latest))


def state_tensors(state):
    """The parameters and Adam moments of a port state."""
    if hasattr(state, "net"):
        params = list(state.net.parameters())
    else:
        params = list(state.params.parameters())
    yield from params
    for p in params:
        moments = state.optimizer.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in moments:
                yield moments[k]


# ---------------------------------------------------------------------
# the resume rules (tests/test_checkpoint.py in the JAX package)
# ---------------------------------------------------------------------

def _stepped(system, state, seed):
    return system.train_step(state, {k: torch.from_numpy(v) for k, v in
                                     _views_batch(seed).items()})[0]


def _params(state):
    return [p.detach().clone() for p in state.params.parameters()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_resume_across_a_backend_switch(tmp_path):
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax")
    state = _stepped(system, state, 0)
    path = ckpt.save_checkpoint(opt, state, 1)
    ckpt.wait_for_saves()
    assert path.endswith("1_state.orbax") and os.path.isdir(path)
    assert sorted(os.listdir(tmp_path / "plain")) == [
        "1_state.orbax", "latest_state.orbax"]
    _, _, fresh = _port("plain", tmp_path)
    ckpt.load_checkpoint(opt, fresh, epoch=1)
    assert fresh.step == 1 and _same(_params(fresh), _params(state))
    ckpt.load_checkpoint(opt, fresh, epoch="latest")
    assert fresh.step == 1
    # a newer msgpack epoch wins the scan; the orbax run reads it
    opt_m, _, _ = _port("plain", tmp_path)
    newer = _stepped(system, state, 1)
    ckpt.save_checkpoint(opt_m, newer, 2)
    opt.continue_train = True
    _, _, resumed = _port("plain", tmp_path)
    assert ckpt.resume_if_requested(opt, resumed) == 2
    assert resumed.step == 2 and _same(_params(resumed), _params(newer))
    # the msgpack run resumes from an orbax epoch
    os.remove(tmp_path / "plain" / "2_state.msgpack")
    opt_m.continue_train = True
    assert ckpt.resume_if_requested(opt_m, resumed) == 1
    assert resumed.step == 1


def test_more_than_one_process_falls_back_to_msgpack(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(ckpt, "_WARNED_MULTIPROCESS", False)
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax",
                               num_processes=2)
    for epoch in (1, 2):
        path = ckpt.save_checkpoint(opt, state, epoch)
        assert path.endswith(f"{epoch}_state.msgpack")
    assert capsys.readouterr().out.count("falls back to msgpack") == 1
    assert not any(f.endswith(".orbax") for f in
                   os.listdir(tmp_path / "plain"))
    _, _, fresh = _port("plain", tmp_path)
    ckpt.load_checkpoint(opt, fresh, epoch=1)
    assert _same(_params(fresh), _params(state))


def test_torn_msgpack_gives_way_to_its_orbax_sibling(tmp_path):
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax")
    state = _stepped(system, state, 0)
    ckpt.save_checkpoint(opt, state, 3)
    ckpt.wait_for_saves()
    (tmp_path / "plain" / "3_state.msgpack").write_bytes(b"torn")
    opt_m, _, fresh = _port("plain", tmp_path)
    ckpt.load_checkpoint(opt_m, fresh, epoch=3)
    assert fresh.step == 1 and _same(_params(fresh), _params(state))


def test_a_torn_latest_falls_back_to_the_newest_intact_epoch(tmp_path):
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax")
    saved = {}
    for epoch in (1, 2, 3):
        state = _stepped(system, state, epoch)
        ckpt.save_checkpoint(opt, state, epoch)
        saved[epoch] = _params(state)
    ckpt.wait_for_saves()
    d = tmp_path / "plain"
    os.remove(d / "latest_state.orbax" / "manifest.ocdbt")
    with open(d / "3_state.orbax" / "_METADATA", "w") as f:
        f.write("{")
    _, _, fresh = _port("plain", tmp_path)
    ckpt.load_checkpoint(opt, fresh, epoch="latest")
    assert fresh.step == 2 and _same(_params(fresh), saved[2])
    opt.continue_train = True
    assert ckpt.resume_if_requested(opt, fresh) == 2
    with pytest.raises(ValueError, match="unreadable orbax checkpoint"):
        ckpt.load_checkpoint(opt, fresh, epoch=3)


def test_init_weights_from_an_orbax_experiment(tmp_path):
    opt, system, src = _port("plain", tmp_path, ckpt_backend="orbax")
    src = _stepped(system, src, 0)
    ckpt.save_checkpoint(opt, src, 4)
    opt2, _, dst = _port("plain", tmp_path, init_weights="plain:4",
                         init_weights_keys="fine/params/(rgb|sigma)/")
    opt2.name = "dst"
    before = _params(dst)
    ckpt.init_weights_from(opt2, dst)       # waits for the save first
    names = [n for n, _ in dst.params.named_parameters()]
    for n, p, q, b in zip(names, dst.params.parameters(),
                          src.params.parameters(), before):
        copied = n.startswith(("fine.rgb.", "fine.sigma."))
        assert torch.equal(p, q if copied else b), n


def test_the_save_copies_the_state_and_commits_in_place(tmp_path):
    opt, system, state = _port("plain", tmp_path, ckpt_backend="orbax")
    ckpt.save_checkpoint(opt, state, 1)
    at_save = _params(state)
    with torch.no_grad():          # training goes on while the thread writes
        for p in state.params.parameters():
            p.add_(1.0)
    state.step = 1
    ckpt.save_checkpoint(opt, state, 2)         # waits for the first
    ckpt.wait_for_saves()
    assert sorted(os.listdir(tmp_path / "plain")) == [
        "1_state.orbax", "2_state.orbax", "latest_state.orbax"]
    _, _, fresh = _port("plain", tmp_path)
    ckpt.load_checkpoint(opt, fresh, epoch=1)
    assert _same(_params(fresh), at_save)
    ckpt.load_checkpoint(opt, fresh, epoch="latest")
    assert fresh.step == 1 and _same(_params(fresh), _params(state))
    meta = json.loads((tmp_path / "plain" / "2_state.orbax" /
                       "_CHECKPOINT_METADATA").read_text())
    assert meta["item_handlers"] == orbax.HANDLER


def test_wait_for_saves_reraises_a_write_error(tmp_path, monkeypatch):
    opt, _, state = _port("plain", tmp_path, ckpt_backend="orbax")

    def full_disk(*args, **kwargs):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ocdbt, "write_store", full_disk)
    ckpt.save_checkpoint(opt, state, 1)        # returns: the thread writes
    with pytest.raises(RuntimeError, match="No space left"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()                      # raised once
    # the temporary directory is left, and no resume takes it
    assert [f for f in os.listdir(tmp_path / "plain")
            if orbax.TMP in f]
    opt.continue_train = True
    assert ckpt.resume_if_requested(opt, state) == 0


# ---------------------------------------------------------------------
# the fixture, and the port without the reference libraries
# ---------------------------------------------------------------------

def test_fixture_matches_its_generator_and_the_port_reads_it():
    want = json.loads((DATA / "orbax_jax_fixture.json").read_text())
    assert make_orbax_fixture.digests(make_orbax_fixture.build()) == \
        want["leaves"]
    sd = orbax.restore(str(DATA / "orbax_jax_fixture"))
    arrays = {k.replace("/", "."): v for k, v in flatten_tree(sd).items()
              if not isinstance(v, dict)}
    assert sorted(arrays) == sorted(want["leaves"])
    for k, a in arrays.items():
        w = want["leaves"][k]
        assert (a.dtype.str, list(a.shape)) == (w["dtype"], w["shape"]), k
        assert hashlib.sha256(a.tobytes()).hexdigest() == w["sha256"], k
    opt = default_options("train", device="cpu", **dict(
        want["options"], img_wh=tuple(want["options"]["img_wh"])))
    state = create_model(opt, device="cpu").create_state(0, 4)
    ckpt.load_state_dict(opt, state, sd["train_state"])
    assert state.step == want["steps"]


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "zstandard", "msgpack")


def test_round_trip_without_the_reference_libraries(tmp_path):
    code = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch
from nerfsr_torch.config import default_options
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt, orbax
opt = default_options("train", device="cpu", model="nerf_downX",
                      dataset_mode="llff_downX", fast_preset="llff",
                      img_wh=(16, 12), downscale=2, precision="f32", D=2,
                      W=16, ckpt_backend="orbax",
                      checkpoints_dir={str(tmp_path)!r}, name="x")
system = create_model(opt, device="cpu")
state = system.create_state(0, steps_per_epoch=4)
ckpt.save_checkpoint(opt, state, 1)
fresh = system.create_state(5, steps_per_epoch=4)
ckpt.load_checkpoint(opt, fresh, epoch=1)
assert all(torch.equal(a, b) for a, b in zip(state.params.parameters(),
                                             fresh.params.parameters()))
orbax.restore({str(DATA / "orbax_jax_fixture")!r})
assert not any(sys.modules.get(n) for n in {BLOCKED!r})
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
