"""Simulated multi-host (DCN) batch scale-out.

Spawns two OS processes, each with 4 virtual CPU devices, joined via
jax.distributed into one 8-device global mesh — the same flat data axis the
single-host path uses, extended over a process boundary (SURVEY.md §5
'Distributed communication backend'). Each process feeds only its own
process_batch_bounds span of the stream batch; the test asserts the global
run's integer outputs equal a single-process run bit-for-bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # two-subprocess tests, ~45 s on the 1-CPU rig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, re, sys
port, pid, nproc, outdir = sys.argv[1:5]
flags = re.sub(
    r"--xla_force_host_platform_device_count=\S+",
    "",
    os.environ.get("XLA_FLAGS", ""),
)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
# Must come BEFORE any backend-touching import (the package __init__s are
# lazy precisely so this ordering is possible).
from swiftmp3_tpu.parallel import initialize_multihost
initialize_multihost(f"127.0.0.1:{port}", int(nproc), int(pid))

from swiftmp3_tpu.models.pipeline import init_carry, make_chunk_fn
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.parallel import make_mesh, process_batch_bounds, put_global
assert jax.process_count() == int(nproc), jax.process_count()
mesh = make_mesh()
assert mesh.devices.size == 8

options = MP3EncoderOptions(mode=Mode.MONO, bitrate_kbps=128)
T, B, n = 2, 8, 1152
lo, hi = process_batch_bounds(mesh, B)
assert hi - lo == 4, (lo, hi)

rng = np.random.default_rng(7)
pcm = (rng.standard_normal((B, T, n)) * 0.4).astype(np.float32)
final = np.zeros((B, T), dtype=bool)
valid = np.ones((B, T), dtype=bool)

carry_np = {k: np.asarray(v) for k, v in init_carry(B, options).items()}
carry = {k: put_global(mesh, v[lo:hi], batch_axis=0) for k, v in carry_np.items()}
pcm_g = put_global(mesh, pcm[lo:hi], batch_axis=0)
fin_g = put_global(mesh, final[lo:hi], batch_axis=0)
val_g = put_global(mesh, valid[lo:hi], batch_axis=0)

run = jax.jit(make_chunk_fn(options))
new_carry, outs = run(carry, pcm_g, fin_g, val_g)
jax.block_until_ready(outs)

# collect this process's addressable rows of the packed output
packed = outs["packed"]
rows = {}
for shard in packed.addressable_shards:
    b0 = shard.index[0].start or 0
    data = np.asarray(shard.data)
    for j in range(data.shape[0]):
        rows[b0 + j] = data[j]
idx = np.array(sorted(rows), dtype=np.int64)
np.save(os.path.join(outdir, f"idx_{pid}.npy"), idx)
np.save(
    os.path.join(outdir, f"out_{pid}.npy"),
    np.stack([rows[i] for i in sorted(rows)], axis=0),
)
print("worker", pid, "ok rows", idx.tolist())
"""


ENCODE_WORKER = r"""
import os, re, sys
port, pid, nproc, outdir = sys.argv[1:5]
flags = re.sub(
    r"--xla_force_host_platform_device_count=\S+",
    "",
    os.environ.get("XLA_FLAGS", ""),
)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from swiftmp3_tpu.parallel import initialize_multihost
initialize_multihost(f"127.0.0.1:{port}", int(nproc), int(pid))

from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.parallel import encode_batch_multihost

def stream(i):
    rng = np.random.default_rng(100 + i)
    return (rng.standard_normal(1152 * (2 + i % 3) + 137 * i) * 0.4).astype(np.float32)

n_per_host = 2
my_streams = [stream(int(pid) * n_per_host + j) for j in range(n_per_host)]
opts = MP3EncoderOptions(mode=Mode.MONO)
blobs = encode_batch_multihost(opts, my_streams, frames_per_step=4)
for j, blob in enumerate(blobs):
    with open(os.path.join(outdir, f"enc_{pid}_{j}.mp3"), "wb") as f:
        f.write(blob)
print("worker", pid, "encoded", [len(b) for b in blobs])
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh_matches_single_process(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid), "2", str(tmp_path)],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"

    # stitch the two hosts' rows into the global [8, T, bytes] output
    parts = {}
    for pid in range(2):
        idx = np.load(tmp_path / f"idx_{pid}.npy")
        out = np.load(tmp_path / f"out_{pid}.npy")
        for j, b in enumerate(idx):
            parts[int(b)] = out[j]
    assert sorted(parts) == list(range(8))
    global_out = np.stack([parts[b] for b in range(8)], axis=0)

    # single-process reference on the in-test 8-device CPU mesh
    import jax

    from swiftmp3_tpu.models.pipeline import init_carry, make_chunk_fn
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode

    options = MP3EncoderOptions(mode=Mode.MONO, bitrate_kbps=128)
    T, B, n = 2, 8, 1152
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((B, T, n)) * 0.4).astype(np.float32)
    final = np.zeros((B, T), dtype=bool)
    valid = np.ones((B, T), dtype=bool)
    run = jax.jit(make_chunk_fn(options))
    _, ref = run(init_carry(B, options), pcm, final, valid)
    np.testing.assert_array_equal(global_out, np.asarray(ref["packed"]))


def test_two_process_encode_batch_multihost_bytes(tmp_path):
    """encode_batch_multihost across 2 processes produces byte streams equal
    to single-session encodes of the same streams."""
    port = _free_port()
    script = tmp_path / "worker_enc.py"
    script.write_text(ENCODE_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid), "2", str(tmp_path)],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"

    from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode

    opts = MP3EncoderOptions(mode=Mode.MONO)
    for i in range(4):
        pid, j = divmod(i, 2)
        got = (tmp_path / f"enc_{pid}_{j}.mp3").read_bytes()
        rng = np.random.default_rng(100 + i)
        pcm = (rng.standard_normal(1152 * (2 + i % 3) + 137 * i) * 0.4).astype(
            np.float32
        )
        s = MP3Encoder(opts, backend="jax").new_session()
        want = s.encode(pcm) + s.flush()
        assert got == want, f"stream {i}: {len(got)} vs {len(want)} bytes"
