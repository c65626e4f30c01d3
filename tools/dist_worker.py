"""Worker process for tests/test_distributed.py: joins the 2-process
JAX cluster, checks the global device namespace, tries a cross-process
collective, decodes its GOP shard, and writes results as JSON."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    coordinator, nproc, pid, stream, out_path = sys.argv[1:6]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")
    import jax

    from av1dec_tpu.parallel import dist
    dist.initialize_distributed(coordinator, int(nproc), int(pid))

    res = {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
    }

    # cross-process collective over the global mesh.
    try:
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = dist.global_mesh()
        n = len(jax.devices())
        arr = jax.make_array_from_callback(
            (n,), NamedSharding(mesh, P("data")),
            lambda idx: jnp.ones((1,), jnp.int32) * jax.process_index())

        def f(x):
            return jax.lax.psum(x, "data")

        out = jax.jit(
            jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                          out_specs=P()))(arr)
        res["psum"] = int(jax.device_get(out)[0])
        res["collective_ok"] = True
    except Exception as e:  # CPU cross-host collectives are optional
        res["collective_ok"] = False
        res["collective_err"] = str(e)[:200]

    # GOP-shard decode: this process's share of the stream
    import hashlib

    import numpy as np
    chunks = dist.decode_my_gops(stream)
    gops = {}
    for gi, frames in chunks:
        md5s = []
        for planes, bd, ss, oh, ft in frames:
            h = hashlib.md5()
            dt = np.uint16 if bd > 8 else np.uint8
            for p in planes:
                h.update(np.ascontiguousarray(p.astype(dt)).tobytes())
            md5s.append(h.hexdigest())
        gops[gi] = md5s
    res["gops"] = gops
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
