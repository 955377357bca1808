"""The reference's dry-run numbers of small cells for
`tests/test_torch_dryrun.py`: run in a fresh process with 4 forced host
devices (the device count locks at jax's first use).

  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/jax_dryrun_ref.py CELLS.json OUT.json

Each cell (arch, mode, seq, batch; SMOKE configs) is lowered and compiled
as `repro.launch.dryrun.run_cell` does, on a (data, model) mesh (2 x 2
unless the cell says `mesh`) of
`AxisType.Auto` axes (under jax 0.9 `jax.make_mesh` defaults to
`Explicit` axes, where the reference's `with_sharding_constraint`s are
asserts). Writes, per cell, XLA's `argument_size_in_bytes` and the loop-
aware `HloCost(...).totals()` of the compiled step.
"""
import json
import sys

import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.dist.sharding import make_mesh_ctx
from repro.launch.hlocost import HloCost
from repro.models.zoo import ModelBundle


def compile_cell(cell, mesh):
    ctx = make_mesh_ctx(mesh)
    bundle = ModelBundle(get_config(cell["arch"], smoke=True))
    seq, batch, mode = cell["seq"], cell["batch"], cell["mode"]
    param_sds = bundle.param_sds()
    param_sh = bundle.param_shardings(ctx)
    if mode == "train":
        batch_sds = bundle.batch_sds(seq=seq, batch=batch, mode="train")
        batch_sh = bundle.batch_shardings(ctx, seq=seq, batch=batch,
                                          mode="train")
        jitted = jax.jit(bundle.train_step(ctx),
                         in_shardings=(param_sh, bundle.opt_shardings(ctx),
                                       batch_sh),
                         out_shardings=(param_sh, bundle.opt_shardings(ctx),
                                        None),
                         donate_argnums=(0, 1))
        lowered = jitted.lower(param_sds, bundle.opt_sds(), batch_sds)
    elif mode == "decode":
        cache_sds = bundle.cache_sds(batch=batch, cache_len=seq)
        cache_sh = bundle.cache_shardings(ctx, batch=batch, cache_len=seq)
        tok_sds = jax.ShapeDtypeStruct((batch, 1), jax.numpy.int32)
        dp = ctx.dp_axes if batch % ctx.dp == 0 else None
        jitted = jax.jit(bundle.decode_step(ctx),
                         in_shardings=(param_sh, cache_sh,
                                       NamedSharding(mesh, P(dp, None)),
                                       NamedSharding(mesh, P())),
                         out_shardings=(None, cache_sh), donate_argnums=(1,))
        lowered = jitted.lower(param_sds, cache_sds, tok_sds,
                               jax.ShapeDtypeStruct((), jax.numpy.int32))
    else:
        raise ValueError(mode)
    compiled = lowered.compile()
    t = HloCost(compiled.as_text()).totals()
    return dict(arg_bytes=int(compiled.memory_analysis()
                              .argument_size_in_bytes),
                flops=t["flops"], hbm_bytes=t["hbm_bytes"],
                collective_bytes=t["collective_bytes"])


def main():
    cells = json.load(open(sys.argv[1]))
    out = {}
    for c in cells:
        mesh = jax.make_mesh(tuple(c.get("mesh", (2, 2))), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            out[c["name"]] = compile_cell(c, mesh)
    with open(sys.argv[2], "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
