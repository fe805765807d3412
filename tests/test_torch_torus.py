"""The port's ring schedules (``core/torus.py``) on 2 and 4 gloo ranks.

The same numpy inputs go through the port's four schedules, one process per
rank (a module-scoped fixture spawns the ranks once), and through the
reference's ``repro.core.torus`` in the forced-8-device subprocess that
``tests/test_torus.py`` uses.  Each output is held against the dense product
and against the reference's, f32, within 1e-5 of its largest entry; the
ring all-reduce must give the same bytes on every rank."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SIZES = (2, 4)

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core import torus
    from repro.launch.mesh import make_device_mesh

    d = dict(np.load(sys.argv[1]))
    out = {}
    for n in (2, 4):
        mesh = make_device_mesh((n,), ("model",))
        f = shard_map(lambda xs, ws: torus.ring_allgather_matmul(xs, ws), mesh=mesh,
                      in_specs=(P("model", None), P(None, "model")),
                      out_specs=P(None, "model"))
        out[f"ag{n}"] = np.asarray(f(d["x"], d["w"]))
        g = shard_map(lambda hs, ws: torus.matmul_reducescatter_ring(hs, ws), mesh=mesh,
                      in_specs=(P(None, "model"), P("model", None)),
                      out_specs=P("model", None))
        out[f"rs{n}"] = np.asarray(g(d["h"], d["w2"]))
        r = shard_map(lambda a: torus.ring_allreduce(a[0])[None], mesh=mesh,
                      in_specs=(P("model", None),), out_specs=P("model", None))
        out[f"ar{n}"] = np.asarray(r(d["vs"][:n]))
        out[f"ffn{n}"] = np.asarray(torus.torus_ffn(jnp.asarray(d["x3"]), d["wg"], d["wu"],
                                                    d["wd"], mesh))
    np.savez(sys.argv[2], **out)
""")

PORT_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch

    from repro_torch.core import torus
    from repro_torch.launch import dist as D
    from repro_torch.launch.mesh import make_device_mesh

    def body(rank, inp, out_dir):
        torch.set_num_threads(1)
        d = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
        for n in (2, 4):
            mesh = make_device_mesh((n,), ("model",))  # every rank makes the groups
            if mesh.coords is None:
                continue
            i = mesh.index("model")
            T, F = d["x"].shape[0], d["w"].shape[1]
            Fl, Tl = F // n, T // n
            ag = torus.ring_allgather_matmul(d["x"][i * Tl:(i + 1) * Tl],
                                             d["w"][:, i * Fl:(i + 1) * Fl], mesh)
            Fh = d["h"].shape[1] // n
            rs = torus.matmul_reducescatter_ring(d["h"][:, i * Fh:(i + 1) * Fh],
                                                 d["w2"][i * Fh:(i + 1) * Fh], mesh)
            ar = torus.ring_allreduce(d["vs"][i], mesh)
            F2 = d["wg"].shape[1] // n
            ffn = torus.torus_ffn(d["x3"], d["wg"][:, i * F2:(i + 1) * F2],
                                  d["wu"][:, i * F2:(i + 1) * F2],
                                  d["wd"][i * F2:(i + 1) * F2], mesh)
            np.savez(f"{out_dir}/tp{n}_r{i}.npz", ag=ag.numpy(), rs=rs.numpy(),
                     ar=ar.numpy(), ffn=ffn.numpy(), hops=mesh.collectives)

    if __name__ == "__main__":
        D.spawn(body, 4, "gloo", args=(sys.argv[1], sys.argv[2]))
""")


def _run(tmp, name, script, *args):
    """Run ``script`` as a file (the spawned ranks import its ``body``)."""
    path = tmp / name
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(path), *args], env=env, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(inputs, JAX outputs, port outputs by tp and rank)."""
    tmp = tmp_path_factory.mktemp("torus")
    rng = np.random.RandomState(0)
    T, D, F = 64, 32, 48
    B, S, D2, F2 = 2, 16, 32, 64
    inp = dict(x=rng.randn(T, D), w=rng.randn(D, F), h=rng.randn(T, F), w2=rng.randn(F, D),
               vs=rng.randn(4, 33), x3=rng.randn(B, S, D2), wg=rng.randn(D2, F2),
               wu=rng.randn(D2, F2), wd=rng.randn(F2, D2))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(tmp / "in.npz", **inp)
    _run(tmp, "jax_torus.py", JAX_SCRIPT, str(tmp / "in.npz"), str(tmp / "jax.npz"))
    _run(tmp, "port_torus.py", PORT_SCRIPT, str(tmp / "in.npz"), str(tmp))
    jax_out = dict(np.load(tmp / "jax.npz"))
    port = {n: [dict(np.load(tmp / f"tp{n}_r{i}.npz")) for i in range(n)] for n in SIZES}
    return inp, jax_out, port


def _dense(inp):
    x3 = inp["x3"].astype(np.float64)
    g = x3 @ inp["wg"]
    return dict(ag=inp["x"] @ inp["w"], rs=inp["h"] @ inp["w2"],
                ffn=(g / (1 + np.exp(-g)) * (x3 @ inp["wu"])) @ inp["wd"])


def _close(got, want):
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= 1e-5 * scale, (
        float(np.max(np.abs(got - want))), scale)


def _assembled(port, n, key):
    """The port's per-rank shards laid out as the reference's out_specs."""
    parts = [port[n][i][key] for i in range(n)]
    return {"ag": lambda: np.concatenate(parts, 1), "rs": lambda: np.concatenate(parts, 0),
            "ffn": lambda: np.concatenate(parts, 1), "ar": lambda: np.stack(parts)}[key]()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("key", ["ag", "rs", "ffn"])
def test_schedule_equals_dense_and_jax(outputs, key, n):
    """All-gather-matmul, matmul-reduce-scatter and the torus FFN: the
    assembled shards against the dense product and the reference's output."""
    inp, jax_out, port = outputs
    got = _assembled(port, n, key)
    _close(got, _dense(inp)[key])
    _close(got, jax_out[f"{key}{n}"])


@pytest.mark.parametrize("n", SIZES)
def test_ring_allreduce_same_bytes_on_every_rank(outputs, n):
    inp, jax_out, port = outputs
    got = _assembled(port, n, "ar")
    assert all(np.array_equal(got[0], g) for g in got)
    _close(got[0], inp["vs"][:n].sum(0))
    _close(got, jax_out[f"ar{n}"])


@pytest.mark.parametrize("n", SIZES)
def test_every_hop_is_a_ring_neighbour_exchange(outputs, n):
    """tp - 1 hops a schedule (two all-gather-matmuls and one
    reduce-scatter in the FFN, a reduce-scatter and an all-gather in the
    all-reduce): each a ``batch_isend_irecv`` with the ring neighbours."""
    _, _, port = outputs
    assert int(port[n][0]["hops"]) == (n - 1) * (1 + 1 + 2 + 3)
