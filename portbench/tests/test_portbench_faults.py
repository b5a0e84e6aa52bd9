"""The harness's verdict on runs with the timed path broken underneath: a
sound tiny run on the CPU is correct, and each fault a cell can have makes
`correct` come out false (the pool loop's live cell too, which
BENCHMARK.json leaves out for now). A cell on one card has no exchange between cards
to leave out. The lower-precision control (TF32 matmuls) runs on the card
only."""

from __future__ import annotations

import pytest

from swiftmp3_tpu_torch.parallel import batch

from .conftest import tiny_run

CELLS = ["compat128.corpus", "hq_joint128.corpus", "compat128.live"]


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: every chunk starts from the
    carry the lane started with."""
    step = batch.BatchEncoder.step

    def stale(self, *args, **kwargs):
        saved = [{k: v.clone() for k, v in c.items()} for c in self._carries]
        out = step(self, *args, **kwargs)
        self._carries = saved
        return out

    monkeypatch.setattr(batch.BatchEncoder, "step", stale)


def _half_left_out(monkeypatch):
    """Half of the batch left out: the odd rows' bytes never come back."""
    drain = batch.BatchEncoder.drain

    def half(self, outs, valid):
        got = drain(self, outs, valid)
        return [b if i % 2 == 0 else b"" for i, b in enumerate(got)]

    monkeypatch.setattr(batch.BatchEncoder, "drain", half)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: in every rendered chunk, one
    bit of the first frame's header (the private bit) flipped."""
    drain = batch.BatchEncoder.drain

    def altered(self, outs, valid):
        return [b[:2] + bytes([b[2] ^ 0x01]) + b[3:] if b else b for b in drain(self, outs, valid)]

    monkeypatch.setattr(batch.BatchEncoder, "drain", altered)


def _main_data_altered(monkeypatch):
    """An answer altered where it is produced, past what the structure walk
    reads: in every rendered chunk, one byte of the first frame's main data
    (byte 100, past the header, CRC and side information) inverted. At the
    cells' 128 frames a step that is 1 frame in 128, 0.78% of compat's
    frames; the structure walk cannot see it, the golden comparison must."""
    drain = batch.BatchEncoder.drain

    def altered(self, outs, valid):
        return [b[:100] + bytes([b[100] ^ 0xFF]) + b[101:] if len(b) > 100 else b for b in drain(self, outs, valid)]

    monkeypatch.setattr(batch.BatchEncoder, "drain", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, lines = tiny_run(cell)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered, _main_data_altered])
def test_a_fault_makes_correct_false(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = tiny_run(cell)
    assert not result["correct"], lines
    if fault is _main_data_altered:  # caught by the golden comparison alone
        assert result["checks"]["structure_errors"]["value"] == 0, lines


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct(cuda_device):
    """The reference's float32 against the port run with TF32 matmuls, on
    the card, at a cell's own shape for one job."""
    import time

    from portbench import run, spec

    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, "compat128.corpus")
    result, lines = run.run_cell(bench, cell, 2**31 + 5, 1.0, False, "cuda", time.perf_counter(),
                                 control="tf32")
    assert not result["correct"], lines
