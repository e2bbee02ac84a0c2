"""The lossy int8 gradient ring (``comm.compress``) against the JAX
package's: ``int8_compress`` == the reference's as traced (``jax.jit``),
bitwise; ``compressed_ring_reduce_scatter`` on ``LocalMesh`` P = 4 and 8
and on 4 gloo processes == the reference's ``shard_map`` ring on 8 forced
host devices (P = 8, and P = 4 on four of them) in a subprocess, bitwise,
and within the quantization of the exact sum."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_rows import one_thread  # noqa: F401
from repro.comm.compress import int8_compress as ref_int8_compress
from repro.comm.compress import int8_decompress as ref_int8_decompress
from repro_torch.comm import (
    LocalMesh,
    compressed_ring_reduce_scatter,
    int8_compress,
    int8_decompress,
)

ROOT = Path(__file__).resolve().parents[1]
#: chunk shapes after the leading [P]: whole blocks, a block shrunk to 8 and to 1
SHAPES = [(1024,), (3, 40), (5,)]


def _inputs(P, shape):
    rng = np.random.default_rng(P * 100 + SHAPES.index(shape))
    full = (P, P) + shape
    return (rng.standard_normal(full) * rng.uniform(0.1, 10, full)).astype(np.float32)


@pytest.mark.parametrize("n,block", [(4096, 256), (96, 32), (8, 8), (256, 256)])
def test_int8_compress_equals_traced_reference(n, block):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 100, n)).astype(np.float32)
    x[:block] = 0.0  # an all-zero block takes scale 1
    q, s = int8_compress(torch.from_numpy(x), block)
    rq, rs = jax.jit(ref_int8_compress, static_argnums=1)(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(rs).view(np.int32))
    got = int8_decompress(q, s, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_int8_decompress(rq, rs, block)))
    assert np.all(np.abs(got.numpy() - x) <= np.repeat(s.numpy(), block) / 2 * (1 + 1e-6))


def _local(P, x):
    mesh = LocalMesh(P, device="cpu")
    outs = mesh.run(lambda ctx: compressed_ring_reduce_scatter(
        ctx.data, torch.from_numpy(x[ctx.data.rank])))
    return np.stack([o.numpy() for o in outs])


_REFERENCE_WORKER = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.comm.compress import compressed_ring_reduce_scatter
    from repro.compat import shard_map

    out = {}
    for p, shape, path in json.loads(sys.argv[1]):
        x = np.load(path)
        mesh = Mesh(np.array(jax.devices()[:p]), ("d",))
        f = shard_map(lambda a: compressed_ring_reduce_scatter(a[0], "d")[None], mesh=mesh,
                      in_specs=P("d"), out_specs=P("d"))
        out[f"{p}-{shape}"] = np.asarray(jax.jit(f)(x)).tolist()
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ring on 8 forced host devices, P = 8 and P = 4, every
    shape; one subprocess."""
    d = tmp_path_factory.mktemp("ring")
    jobs = []
    for P in (4, 8):
        for i, shape in enumerate(SHAPES):
            path = d / f"x{P}_{i}.npy"
            np.save(path, _inputs(P, shape))
            jobs.append((P, str(shape), str(path)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_WORKER, json.dumps(jobs)], env=env,
                          capture_output=True, text=True, timeout=110)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.split("RESULT ", 1)[1])
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("P", [4, 8])
def test_local_mesh_ring_equals_reference(reference, P, shape):
    x = _inputs(P, shape)
    got = _local(P, x)
    want = reference[f"{P}-{shape}"]
    np.testing.assert_array_equal(got, want)
    # each hop requantizes the partial sum: within P - 1 half-quanta of the
    # largest partial, in whole (and the first chunk's own rounding)
    exact = x.sum(0)
    assert np.abs(got - exact).max() <= P * np.abs(x).sum(0).max() / 127


def test_ring_refuses_a_wrong_leading_axis():
    mesh = LocalMesh(2, device="cpu")
    with pytest.raises(ValueError, match="takes \\[P=2"):
        mesh.run(lambda ctx: compressed_ring_reduce_scatter(ctx.data, torch.zeros(3, 8)))


_GLOO_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def work(rank, world, port, jobs, out_path):
        sys.path.insert(0, %r)
        from repro_torch.comm import compressed_ring_reduce_scatter
        from repro_torch.launch.mesh import process_mesh

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        mesh = process_mesh(data=world, device="cpu")
        out = {}
        for shape, path in jobs:
            x = torch.from_numpy(np.load(path)[rank])
            got = mesh.run(lambda ctx: compressed_ring_reduce_scatter(ctx.data, x))[0]
            out[shape] = got.tolist()
        with open(f"{out_path}.{rank}", "w") as fh:
            json.dump(out, fh)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(work, args=(4, port, json.loads(sys.argv[1]), sys.argv[2]), nprocs=4, join=True)
""" % (str(ROOT / "src"),))


def test_gloo_processes_equal_reference(reference, tmp_path):
    """Four gloo processes (``ProcessGroupComm``; int8 payloads cross as
    bytes) == the reference's P = 4 ring, rank by rank."""
    jobs = []
    for i, shape in enumerate(SHAPES):
        path = tmp_path / f"x{i}.npy"
        np.save(path, _inputs(4, shape))
        jobs.append((str(shape), str(path)))
    script = tmp_path / "gloo_ring.py"
    script.write_text(_GLOO_WORKER)
    out_path = tmp_path / "out.json"
    proc = subprocess.run([sys.executable, str(script), json.dumps(jobs), str(out_path)],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for shape in SHAPES:
        got = np.stack([np.asarray(json.loads(Path(f"{out_path}.{r}").read_text())[str(shape)],
                                   np.float32) for r in range(4)])
        np.testing.assert_array_equal(got, reference[f"4-{shape}"])
