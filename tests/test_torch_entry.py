"""The port's graft entry (`swiftmp3_tpu_torch/graft_entry.py`) on the CPU,
held against `__graft_entry__.py`.

- `entry("cpu")` against the live JAX `entry()` under `jax.jit`: the same
  inputs, every fetched field and the packed bytes exact, the new carry
  through `carry_to_jax` (integers exact, floats within the MDCT tests'
  1e-5 x scale).
- `dryrun_multichip(n, device="cpu")` against the JAX dry run over n = 1,
  2, 4 and 8 virtual CPU devices, frozen in `tests/fixtures/torch/jax_entry.npz`
  (`python -m tests.torch_freeze_fixtures entry`; the JAX dry run compiles
  the hq program, too slow to run live here): both steps, every fetched
  field exact, the carries as above. The same file's entry step is the live
  one's.
- Positions: 1, 3 and 4 CPU positions give what one run of the chunk
  program on all the rows gives.
- No fallback: without a card, `entry()` and `dryrun_multichip(2)` raise.
- The module's self-test (`main(["--device", "cpu"])`) prints the
  reference's lines.
"""

from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import swiftmp3_tpu.utils as jutils
from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode as JaxMode
from swiftmp3_tpu_torch import graft_entry
from swiftmp3_tpu_torch.graft_entry import dryrun_inputs, dryrun_multichip, entry
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.options import MP3EncoderOptions

from . import torch_inputs as ti

torch.set_num_threads(1)

CPU = torch.device("cpu")
MDCT_TOLERANCE = 1e-5  # x scale, tests/test_torch_dsp.py's for the MDCT

_DRYRUNS = {}


def _dryrun(n: int) -> dict:
    """dryrun_multichip(n, device="cpu"), run once a module."""
    if n not in _DRYRUNS:
        _DRYRUNS[n] = dryrun_multichip(n, device="cpu")
    return _DRYRUNS[n]


def _assert_carry_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        have = np.asarray(got[k])
        assert have.dtype == ref.dtype and have.shape == ref.shape, k
        if ref.dtype == np.float32:
            scale = max(float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0)), 1.0)
            assert np.array_equal(np.isfinite(have), np.isfinite(ref)), k
            err = np.abs(np.where(np.isfinite(ref), have - ref, 0)).max(initial=0.0)
            assert err <= MDCT_TOLERANCE * scale, (k, err)
        else:
            assert np.array_equal(have, ref), k


def test_entry_matches_the_live_jax_entry(monkeypatch):
    # the reference entry points JAX at its own compilation cache; the test
    # process keeps the one tests/conftest.py set
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda *args, **kwargs: None)
    jfn, jargs = jentry.entry()
    tfn, targs = entry("cpu")
    jcarry, *jinputs = jargs
    tcarry, *tinputs = targs
    for j, t in zip(jinputs, tinputs):
        assert t.device == CPU and np.array_equal(t.numpy(), j) and t.numpy().dtype == j.dtype
    _assert_carry_equal(tpipe.carry_to_jax(tcarry), {k: np.asarray(v) for k, v in jcarry.items()})

    jc, jo = jax.jit(jfn)(*jargs)
    tc, to = tfn(*targs)
    o = JaxOptions(mode=JaxMode.STEREO, bitrate_kbps=128)
    want = jpipe.fetch_outputs(jo, o)
    got = tpipe.fetch_outputs(to, MP3EncoderOptions(mode="stereo", bitrate_kbps=128))
    assert ti.differing_frames(got, want) == 0
    assert np.array_equal(to["packed"].numpy(), np.asarray(jo["packed"]))
    _assert_carry_equal(tpipe.carry_to_jax(tc), {k: np.asarray(v) for k, v in jc.items()})
    # the frozen copy chip_smoke.py compares the card with is this step's
    frozen, frozen_carry = ti.frozen_entry("entry")
    assert ti.differing_frames(frozen, want) == 0
    _assert_carry_equal(frozen_carry, {k: np.asarray(v) for k, v in jc.items()})


@pytest.mark.parametrize("n", ti.ENTRY_DRYRUN_POSITIONS)
def test_dryrun_matches_the_frozen_jax_dryrun(n):
    """n CPU positions, batch 2n, both steps: every fetched field and
    main_data byte exact against the JAX dry run over n devices."""
    got = _dryrun(n)
    assert sorted(got) == ["hq", "vbr"]
    for step in ("vbr", "hq"):
        outputs, carry = got[step]
        want, want_carry = ti.frozen_entry(f"dry{n}.{step}")
        assert ti.differing_frames(outputs, want) == 0, step
        _assert_carry_equal(carry, want_carry)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_dryrun_positions_equal_one_run_of_the_rows(n):
    """The mesh's split, per-position carries and row-order join give what
    the chunk program gives on all 2n rows at once."""
    got = _dryrun(n)
    for step, (options, pcm, la) in dryrun_inputs(2 * n, 2).items():
        B, T = pcm.shape[:2]
        carry, outs = tpipe.make_chunk_fn(options)(
            tpipe.init_carry(B, options, CPU), torch.from_numpy(pcm),
            torch.zeros((B, T), dtype=torch.bool), torch.ones((B, T), dtype=torch.bool),
            None if la is None else torch.from_numpy(la),
        )
        outputs, mesh_carry = got[step]
        assert ti.differing_frames(outputs, tpipe.fetch_outputs(outs, options)) == 0, step
        want = tpipe.carry_to_jax(carry)
        assert sorted(mesh_carry) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(mesh_carry[k], v), (step, k)


def test_entry_and_dryrun_run_on_the_card_and_raise_without_one(monkeypatch):
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    assert inspect.signature(dryrun_multichip).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cpu_run(*args, **kwargs):
        raise AssertionError("a default call ran the chunk program")

    monkeypatch.setattr(graft_entry, "init_carry", no_cpu_run)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            dryrun_multichip(2, device=device)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multichip(2, device="cuda:0")


def test_self_test_prints_the_reference_lines(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "entry ok", "dryrun_multichip ok: 8 devices, batch 16, mesh {'data': 8}"
    ]
