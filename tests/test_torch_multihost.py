"""The port's multi-process batch on the CPU: two processes joined by
`initialize_multihost` (gloo on 127.0.0.1), each with 2 CPU positions of a
4-position global mesh, each passing its own 2 streams to
`encode_batch_multihost`.

The two processes' streams, concatenated, equal one process's encode_batch
of all four and the JAX package's frozen mesh bytes of the same streams
(tests/torch_freeze_fixtures.py, part mesh). Their streams differ in length
across the processes, so the step count comes from the gathered longest
stream. Each worker also checks that `make_mesh()` gathers every process's
cards process-major (two reported cards a process, which this host does
not have: the encode runs on the CPU positions of the same layout).
"""

import os
import socket
import subprocess
import sys

import torch

from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import encode_batch

from . import torch_inputs as ti

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import torch
torch.set_num_threads(1)
from swiftmp3_tpu_torch.parallel import initialize_multihost
initialize_multihost(f"127.0.0.1:{port}", 2, pid)

from swiftmp3_tpu_torch.parallel import encode_batch_multihost, make_mesh, process_batch_bounds
from swiftmp3_tpu_torch.parallel.mesh import Mesh, process_count, process_index
from tests import torch_inputs as ti

assert (process_count(), process_index()) == (2, pid)
torch.cuda.is_available = lambda: True  # two cards a process, for the gather alone
torch.cuda.device_count = lambda: 2
cards = make_mesh()
assert [(p, str(d)) for p, d in cards.positions] == [
    (0, "cuda:0"), (0, "cuda:1"), (1, "cuda:0"), (1, "cuda:1")], cards.positions
mesh = Mesh(tuple((p, "cpu") for p, _ in cards.positions))
assert process_batch_bounds(mesh, 4) == (2 * pid, 2 * pid + 2)

factory, kw = ti.MESH_OPTIONS["mono"]
from swiftmp3_tpu_torch.options import MP3EncoderOptions
opts = ti.build_options(factory, kw, MP3EncoderOptions)
mine = ti.mesh_streams("mono")[2 * pid : 2 * pid + 2]
blobs = encode_batch_multihost(opts, mine, frames_per_step=ti.MESH_STEP, mesh=mesh)
for j, blob in enumerate(blobs):
    with open(os.path.join(outdir, f"enc_{pid}_{j}.mp3"), "wb") as fh:
        fh.write(blob)
torch.distributed.destroy_process_group()
print("worker", pid, "encoded", [len(b) for b in blobs])
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_give_the_one_process_bytes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid), str(tmp_path)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"

    got = [(tmp_path / f"enc_{i // 2}_{i % 2}.mp3").read_bytes() for i in range(4)]
    factory, kw = ti.MESH_OPTIONS["mono"]
    o = ti.build_options(factory, kw, MP3EncoderOptions)
    streams = ti.mesh_streams("mono")[:4]
    frames = [len(ti.walk_frames(g)) for g in got]
    assert max(frames[:2]) < max(frames[2:])  # process 0 alone would stop a step early
    assert got == encode_batch(o, streams, "cpu", frames_per_step=ti.MESH_STEP)
    for i, data in enumerate(got):
        with open(ti.jax_path(f"mesh_mono_{i}"), "rb") as fh:
            assert data == fh.read(), f"stream {i}"
