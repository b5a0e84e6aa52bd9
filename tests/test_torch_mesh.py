"""The port's data mesh and the `mesh=` entry points on the CPU, held against
the JAX package.

- Directly against the JAX package, with no JAX compile: the port's
  `make_mesh(["cpu"] * 8)` against JAX's `make_mesh()` on the 8 virtual CPU
  devices (tests/conftest.py); `process_batch_bounds` on a grid of
  (global batch, mesh size), errors included; the padding and the chunks
  `encode_batch` feeds its encoder over a mesh (both packages' encoders
  replaced by a recorder), and the global batch of `encode_batch_multihost`.
- Against frozen JAX bytes (tests/torch_freeze_fixtures.py, part mesh): the
  port's `encode_batch` over a 4-position CPU mesh, `use_mesh` over a
  3-position one (the batch pads), `encode_corpus(mesh=)` and the
  single-process `encode_batch_multihost` equal the JAX package's bytes.
- Within the port: 1, 3 and 4 positions give the bytes of `device="cpu"`;
  `StreamPool(mesh=)` with lane churn equals sessions; `reset_lanes` under a
  mesh gives fresh lanes; the mesh carry reads as the one-device carry
  through `carry_to_jax`; `make_mesh()` raises without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import swiftmp3_tpu.parallel.batch as jbatch
import swiftmp3_tpu.parallel.mesh as jmesh
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode as JaxMode
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.options import ID3Tag, MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import (
    BatchEncoder,
    StreamPool,
    batch_sharding,
    carry_sharding,
    encode_batch,
    encode_batch_multihost,
    encode_corpus,
    make_mesh,
    process_batch_bounds,
    put_global,
)
from swiftmp3_tpu_torch.parallel import batch as tbatch
from swiftmp3_tpu_torch.parallel.mesh import Mesh

from . import torch_inputs as ti

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _options(name: str):
    factory, kw = ti.MESH_OPTIONS[name]
    return ti.build_options(factory, kw, MP3EncoderOptions)


def _frozen(stem: str) -> bytes:
    with open(ti.jax_path(stem), "rb") as fh:
        return fh.read()


def _session_encode(o, pcm) -> bytes:
    s = new_session(o, CPU)
    return s.encode(pcm) + s.flush()


# --- against the JAX package, no compile ---------------------------------------


def test_make_mesh_matches_the_jax_mesh_on_eight_devices():
    import jax

    jm = jmesh.make_mesh()
    tm = make_mesh(["cpu"] * 8)
    assert dict(jm.shape) == tm.shape == {"data": 8}
    assert jm.devices.size == tm.size
    assert [d.process_index for d in jm.devices.flat] == [p for p, _ in tm.positions]
    assert tm.local_positions() == list(range(8)) and jax.process_index() == 0
    assert all(d == CPU for d in tm.devices)


BOUNDS_GRID = [(gb, n) for n in (1, 2, 3, 4, 8) for gb in (0, 1, 2, 3, 4, 6, 8, 9, 12, 16, 24)]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_process_batch_bounds_match_jax(n_dev):
    """Every global batch of the grid: the same [lo, hi), or the same
    ValueError."""
    import jax

    jm = jmesh.make_mesh(jax.devices()[:n_dev])
    tm = make_mesh(["cpu"] * n_dev)
    for gb, n in BOUNDS_GRID:
        if n != n_dev:
            continue
        try:
            want = jmesh.process_batch_bounds(jm, gb)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                process_batch_bounds(tm, gb)
            assert str(got.value) == str(e)
            continue
        assert process_batch_bounds(tm, gb) == want, (gb, n_dev)


def test_process_batch_bounds_across_processes():
    """The span of this process (index 0) on meshes that span processes: a
    process-major mesh gives its contiguous span, one without this process
    (0, 0), and an interleaved one raises (the reference's contiguity
    error)."""
    assert process_batch_bounds(Mesh(((0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu"))), 8) == (0, 4)
    assert process_batch_bounds(Mesh(((1, "cpu"), (0, "cpu"), (0, "cpu"))), 9) == (3, 9)
    assert process_batch_bounds(Mesh(((1, "cpu"), (1, "cpu"))), 4) == (0, 0)
    with pytest.raises(ValueError, match="not contiguous on the data axis"):
        process_batch_bounds(Mesh(((0, "cpu"), (1, "cpu"), (0, "cpu"))), 6)


def test_put_global_splits_rows_over_the_local_positions():
    mesh = Mesh(((0, "cpu"), (0, "cpu"), (0, "cpu"), (1, "cpu")))
    rows = np.arange(6 * 2 * 3).reshape(6, 2, 3)
    parts = put_global(mesh, rows)
    assert [p.shape for p in parts] == [(2, 2, 3)] * 3
    assert np.array_equal(torch.cat(parts).numpy(), rows)
    assert [(d.type, lo, hi) for d, lo, hi in carry_sharding(mesh).spans(6)] == [
        ("cpu", 0, 2), ("cpu", 2, 4), ("cpu", 4, 6)
    ]
    axis1 = put_global(mesh, rows.transpose(1, 0, 2), batch_axis=1)
    assert np.array_equal(torch.cat(axis1, dim=1).numpy(), rows.transpose(1, 0, 2))
    assert batch_sharding(mesh, 1).batch_axis == 1
    with pytest.raises(ValueError, match="do not split evenly"):
        put_global(mesh, rows[:5])


class _Recorder:
    """Stands in for either package's BatchEncoder: records the batch it
    was built for and every chunk it is given; renders nothing."""

    def __init__(self, log, options, batch, *args, **kwargs):
        self.log, self.batch = log, batch
        log.append(("batch", batch))
        self.renderers = []

    def prepare(self, pcm, final, valid, lookahead=None):
        return pcm, final, valid, lookahead

    def step(self, pcm, final, valid, lookahead=None):
        self.log.append(tuple(None if x is None else np.array(x) for x in (pcm, final, valid, lookahead)))

    def drain(self, outs, valid):
        return [b""] * len(valid)

    def flush(self):
        return [b""] * self.batch

    def close(self):
        pass


def _recorded(module, monkeypatch, *args, **kwargs) -> list:
    log = []
    monkeypatch.setattr(module, "BatchEncoder", lambda *a, **k: _Recorder(log, *a, **k))
    module.encode_batch(*args, **kwargs)
    return log


@pytest.mark.parametrize("n_dev", [None, 3, 4, 8])
@pytest.mark.parametrize("name,gapless", [("mono", False), ("hq", False), ("hq", True)])
def test_encode_batch_feeds_the_chunks_of_the_jax_package(name, gapless, n_dev, monkeypatch):
    """Over no mesh or a mesh of n_dev positions, the port's encode_batch
    pads the batch as the JAX package's does and feeds its encoder the same
    chunks (pcm in the same dtype, final, valid, lookahead), gapless tail
    and window-sequencing delay included."""
    import jax

    factory, kw = ti.MESH_OPTIONS[name]
    o = ti.build_options(factory, dict(kw, gapless_info=gapless), MP3EncoderOptions)
    jo = ti.build_options(factory, dict(kw, gapless_info=gapless), JaxOptions, JaxMode)
    streams = ti.mesh_streams(name)
    jm = tm = None
    if n_dev:
        jm, tm = jmesh.make_mesh(jax.devices()[:n_dev]), make_mesh(["cpu"] * n_dev)
    want = _recorded(jbatch, monkeypatch, jo, streams, frames_per_step=ti.MESH_STEP, mesh=jm)
    got = _recorded(tbatch, monkeypatch, o, streams, "cpu", frames_per_step=ti.MESH_STEP, mesh=tm)
    assert got[0] == want[0] and len(got) == len(want) > 2
    for g, w in zip(got[1:], want[1:]):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("n_local,n_dev", [(0, 1), (1, 8), (2, 4), (5, 4), (5, 3), (8, 8)])
def test_encode_batch_multihost_global_batch_matches_jax(n_local, n_dev, monkeypatch):
    """The global batch each package's encode_batch_multihost asks the mesh
    for: the local streams padded to a multiple of the local positions (at
    least one row a position)."""
    import jax

    seen = {}

    def record(side):
        def bounds(mesh, global_batch):
            seen[side] = global_batch
            raise _Stop

        return bounds

    streams = ti.mesh_streams("mono")[:n_local]
    jo = ti.build_options(None, ti.MESH_OPTIONS["mono"][1], JaxOptions, JaxMode)
    monkeypatch.setattr(jmesh, "process_batch_bounds", record("jax"))
    monkeypatch.setattr(tbatch, "process_batch_bounds", record("port"))
    with pytest.raises(_Stop):
        jbatch.encode_batch_multihost(jo, streams, 4, jmesh.make_mesh(jax.devices()[:n_dev]))
    with pytest.raises(_Stop):
        encode_batch_multihost(_options("mono"), streams, 4, make_mesh(["cpu"] * n_dev))
    assert seen["port"] == seen["jax"]


# --- against the JAX package's frozen bytes -------------------------------------------


def test_mesh_encode_batch_matches_the_jax_mesh_bytes():
    """Compat mono over 4 CPU positions (5 streams pad to 8 rows), and the
    hq joint-stereo set with lookahead, an empty and an int16 stream."""
    for name in ti.MESH_OPTIONS:
        got = encode_batch(_options(name), ti.mesh_streams(name), frames_per_step=ti.MESH_STEP,
                           mesh=make_mesh(["cpu"] * 4))
        for i, data in enumerate(got):
            assert data == _frozen(f"mesh_{name}_{i}"), f"{name} stream {i}"
    assert got[1] == b""


def test_use_mesh_pads_over_a_three_position_mesh(monkeypatch):
    """use_mesh without a mesh takes make_mesh() (here 3 CPU positions: the
    5 streams pad to 6 rows); the bytes are the JAX package's."""
    monkeypatch.setattr(tbatch, "make_mesh", lambda: make_mesh(["cpu"] * 3))
    got = encode_batch(_options("mono"), ti.mesh_streams("mono"), frames_per_step=ti.MESH_STEP,
                       use_mesh=True)
    assert got == [_frozen(f"mesh_mono_{i}") for i in range(5)]


def test_encode_corpus_over_a_mesh_matches_the_jax_file():
    o = MP3EncoderOptions(**ti.CORPUS_OPTIONS)
    tags = [ID3Tag(title=t, artist=a) for t, a in ti.CORPUS_TAGS]
    files = encode_corpus(o, ti.corpus_streams(), tags=tags, frames_per_step=4,
                          mesh=make_mesh(["cpu"] * 4))
    assert files[0] == _frozen("corpus_file0")
    assert files == encode_corpus(o, ti.corpus_streams(), tags=tags, device="cpu", frames_per_step=4)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_multihost_single_process_matches_the_jax_bytes(dtype):
    """One process: encode_batch_multihost over 4 CPU positions gives the JAX
    package's single-process bytes (float32 and raw int16 transport), which
    are its sessions'."""
    pcm = ti.multihost_streams()[dtype]
    o = _options("mono")
    got = encode_batch_multihost(o, [pcm], frames_per_step=ti.MESH_STEP, mesh=make_mesh(["cpu"] * 4))
    assert got == [_frozen(f"multihost_{dtype}")]
    assert got[0] == _session_encode(o, pcm)


def test_multihost_omits_the_gapless_tail_as_the_reference_does():
    """Under gapless_info, encode_batch (like a session) pads each stream's
    tail by delay + 529 zeros and encode_batch_multihost does not, as in the
    reference (ROADMAP Queue 3): its stream ends sooner."""
    o = ti.build_options(None, dict(ti.MESH_OPTIONS["mono"][1], gapless_info=True), MP3EncoderOptions)
    pcm = ti.multihost_streams()["float32"]
    mesh = make_mesh(["cpu"] * 2)
    multi = encode_batch_multihost(o, [pcm], frames_per_step=ti.MESH_STEP, mesh=mesh)[0]
    whole = encode_batch(o, [pcm], frames_per_step=ti.MESH_STEP, mesh=mesh)[0]
    assert whole == _session_encode(o, pcm)
    assert len(ti.walk_frames(multi)) < len(ti.walk_frames(whole))


# --- within the port --------------------------------------------------------------


@pytest.mark.parametrize("name", list(ti.MESH_OPTIONS))
def test_positions_give_the_one_device_bytes(name):
    o = _options(name)
    streams = ti.mesh_streams(name)
    want = encode_batch(o, streams, "cpu", frames_per_step=ti.MESH_STEP)
    for n in (1, 3, 4):
        assert encode_batch(o, streams, frames_per_step=ti.MESH_STEP,
                            mesh=make_mesh(["cpu"] * n)) == want, n


def test_batch_encoder_needs_a_batch_that_divides_over_the_mesh():
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        BatchEncoder(_options("mono"), 6, 2, mesh=make_mesh(["cpu"] * 4))


def test_mesh_carry_reads_as_the_one_device_carry():
    """After a step, the carry of a 4-position encoder (each position's
    carry joined in position order) equals the one-device encoder's bit for
    bit through carry_to_jax, and a mesh encoder restarted from it (the
    checkpoint path) continues with the same bytes."""
    o = MP3EncoderOptions.hq(mode="stereo", bitrate_kbps=96, reservoir_depth=3)
    B, T = 4, 2
    rng = np.random.default_rng(9)
    pcm = (rng.standard_normal((2, B, T, 2304)) * 0.3).astype(np.float32)
    la = (rng.standard_normal((2, B, T, 1152)) * 0.3).astype(np.float32)
    fin = np.zeros((B, T), dtype=bool)
    val = np.ones((B, T), dtype=bool)
    one = BatchEncoder(o, B, T, CPU)
    four = BatchEncoder(o, B, T, mesh=make_mesh(["cpu"] * 4))
    for enc in (one, four):
        enc.drain(enc.step(pcm[0], fin, val, la[0]), val)
    a, b = tpipe.carry_to_jax(one.carry), tpipe.carry_to_jax(four.carry)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    resumed = BatchEncoder(o, B, T, mesh=make_mesh(["cpu"] * 2))
    state = tpipe.carry_from_jax(b, CPU, o)
    resumed._carries = [{k: v[lo:hi] for k, v in state.items()} for _, lo, hi in resumed._spans]
    resumed.renderers = four.renderers
    got = resumed.drain(resumed.step(pcm[1], fin, val, la[1]), val)
    assert got == one.drain(one.step(pcm[1], fin, val, la[1]), val)
    one.close(), four.close(), resumed.close()


def test_reset_lanes_under_a_mesh_gives_fresh_lanes():
    """Masked lanes on two of three positions take init_carry's state and
    fresh renderers; the rest keep their carry bit for bit."""
    o = MP3EncoderOptions(mode="stereo")
    B, T = 6, 2
    enc = BatchEncoder(o, B, T, mesh=make_mesh(["cpu"] * 3))
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal((B, T, 2304)) * 0.3).astype(np.float32)
    val = np.ones((B, T), dtype=bool)
    enc.drain(enc.step(pcm, np.zeros((B, T), dtype=bool), val), val)
    before = {k: v.clone() for k, v in enc.carry.items()}
    renderers = list(enc.renderers)
    mask = np.array([False, True, False, False, True, True])
    enc.reset_lanes(mask)
    init = tpipe.init_carry(B, o, CPU)
    for k, v in enc.carry.items():
        assert v[~mask].numpy().tobytes() == before[k][~mask].numpy().tobytes(), k
        assert v[mask].numpy().tobytes() == init[k][mask].numpy().tobytes(), k
    assert not torch.equal(before["fb_hist"][mask], init["fb_hist"][mask])
    assert [r is s for r, s in zip(enc.renderers, renderers)] == list(~mask)
    enc.close()


@pytest.mark.parametrize("pipelined", [True, False])
def test_pool_over_a_mesh_matches_sessions(pipelined):
    """Lane churn over 2 CPU positions (4 lanes): more streams than lanes,
    staggered arrivals, an empty and an int16 stream, lanes recycled on
    both positions; every stream equals its session."""
    o = MP3EncoderOptions(mode="mono", bitrate_kbps=64)
    rng = np.random.default_rng(1)
    lengths = [3 * 1152 + 400, 2 * 1152, 5 * 1152 + 1, 1152 // 2, 0, 4 * 1152, 2 * 1152 + 9]
    sigs = [(0.4 * np.sin(np.arange(n) * rng.uniform(0.01, 0.2))).astype(np.float32) for n in lengths]
    sigs[3] = (sigs[3] * 32767).astype(np.int16)
    pool = StreamPool(o, lanes=4, frames_per_step=2, pipelined=pipelined, mesh=make_mesh(["cpu"] * 2))
    sids, pending = [], list(range(len(sigs)))
    for _ in range(200):
        if pool.idle and not pending:
            break
        for _ in range(2 if pending else 0):
            if pending:
                i = pending.pop(0)
                sid = pool.submit()
                pool.feed(sid, sigs[i])
                pool.close(sid)
                sids.append(sid)
        pool.step()
    pool.run_until_idle()
    for i, sid in enumerate(sids):
        assert pool.result(sid) == _session_encode(o, sigs[i]), f"stream {i}"
    pool.shutdown()


def test_make_mesh_raises_without_a_card(monkeypatch):
    """The default mesh is every card; without one it raises rather than
    fall back to the CPU, and so do use_mesh and encode_batch_multihost."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        make_mesh()
    pcm = ti.multihost_streams()["float32"]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        encode_batch(_options("mono"), [pcm], use_mesh=True)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        encode_batch_multihost(_options("mono"), [pcm])
