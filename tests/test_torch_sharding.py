"""The port's sharding rules and meshes (``sharding/rules.py``,
``launch/mesh.py``, ``launch/steps.py``'s spec bookkeeping) against the
JAX package.

The reference's ``test_sharding.py`` mirrored on the same inputs (a path
is a tuple of key names here, of ``DictKey``s there). Then every config
of ``configs/`` at the production meshes (16, 16) and (2, 16, 16), in
both modes, from shapes alone: the port's parameter shapes on the meta
device against the reference's ``jax.eval_shape``; the param specs, the
scatter dims and the optimizer specs must be equal leaf for leaf. Then
the meshes over gloo ranks (spawn) at world 1, 2 and 4: ``make_host_mesh``
lays the ranks out row-major over ("data", "model"), and
``make_production_mesh`` refuses a world of another size; and
``shard_of`` / ``unshard`` cut and rebuild a leaf over ("pod", "data").
"""
import json
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.compat import Mesh
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P

TIMEOUT = 120
WORLDS = (1, 2, 4)


def test_attention_heads_sharded_when_divisible():
    assert rules.tp_dim(("attn", "wq"), (48, 6144, 48, 128), 16) == 2
    assert rules.tp_dim(("attn", "wo"), (48, 48, 128, 6144), 16) == 1
    # phi4: 24 heads don't divide 16 -> replicated
    assert rules.tp_dim(("attn", "wq"), (32, 3072, 24, 128), 16) is None
    # qwen kv=2 -> replicated
    assert rules.tp_dim(("attn", "wk"), (36, 2048, 2, 128), 16) is None


def test_mlp_ff_sharded():
    assert rules.tp_dim(("mlp", "w1"), (62, 5376, 21504), 16) == 2
    assert rules.tp_dim(("mlp", "w2"), (62, 21504, 5376), 16) == 1


def test_expert_ff_sharded():
    assert rules.tp_dim(("moe", "experts", "w1"),
                        (64, 8, 6144, 32768), 16) == 3
    assert rules.tp_dim(("moe", "experts", "w2"),
                        (64, 8, 32768, 6144), 16) == 2


def test_embed_vocab_sharded_else_dmodel():
    assert rules.tp_dim(("embed",), (262144, 5376), 16) == 0
    # mamba2 vocab 50280 % 16 != 0 -> not sharded over 'model' (the
    # reference's test accepts either answer; both packages give None)
    assert rules.tp_dim(("embed",), (50280, 1536), 16) is None
    spec = rules.param_spec(("embed",), torch.empty(50280, 1536,
                                                    device="meta"),
                            rules.MeshAxes(("data",)), 16, 16, "fsdp")
    assert spec == P(None, "data")


def test_fsdp_dim_skips_stack_and_tp_dims():
    # stacked leaf: dim0 is the scan dim, dim2 is TP -> dim1 (d_model)
    d = rules.fsdp_dim(("groups", "0", "s0", "mlp", "w1"),
                       (62, 5376, 21504), 32, taken=2)
    assert d == 1
    # nothing divisible -> None
    assert rules.fsdp_dim(("groups", "0", "s0", "n1"), (62, 5377), 32,
                          None) is None


def test_manual_only_strips_auto_axes():
    s = rules.manual_only(P(None, ("pod", "data"), "model"),
                          ("pod", "data"))
    assert s == P(None, ("pod", "data"))
    s2 = rules.manual_only(P("model"), ("pod", "data"))
    assert s2 == P(None) or s2 == P()


def test_mode_for():
    assert rules.mode_for("grok-1-314b") == "fsdp"
    assert rules.mode_for("llama-3.2-vision-90b") == "fsdp"
    assert rules.mode_for("qwen2.5-3b") == "zero1"


# -- every config at the production meshes, from shapes alone --------------

PRODUCTION = (((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")))


def _reference_specs(name: str, shape, names, mode: str):
    """The reference's param specs, scatter dims and optimizer specs of
    ``name`` at a mesh of ``shape`` (only its sizes are read), keyed by
    the "."-joined leaf path, each spec as a tuple of entries."""
    from functools import partial

    import jax

    from repro.configs.base import get_arch as jget
    from repro.launch import steps as jsteps
    from repro.models import api as japi
    from repro.sharding import rules as jrules
    cfg = jget(name)
    shapes = jax.eval_shape(partial(japi.init_params, cfg=cfg),
                            jax.random.key(0))
    mesh = SimpleNamespace(shape=dict(zip(names, shape)))
    manual = tuple(a for a in ("pod", "data") if a in names)
    axes = jrules.MeshAxes(data=manual)
    n_dp, n_model = axes.sizes(mesh)
    pspecs = jrules.param_specs(shapes, axes, mesh, mode)
    dims = jsteps.scatter_dims_tree(shapes, n_dp, n_model)
    ospecs = jsteps.opt_specs(pspecs, dims, manual)

    def flat(tree, leaf=None):
        return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=leaf)[0]}
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return ({k: tuple(v) for k, v in flat(pspecs, is_p).items()},
            flat(dims),
            {k: tuple(v) for k, v in flat(ospecs, is_p).items()})


@pytest.mark.parametrize("name", list_archs())
def test_param_specs_match_reference(name):
    shapes = api.param_shapes(get_arch(name))
    for shape, names in PRODUCTION:
        mesh = Mesh(shape, names, {})
        manual = tuple(a for a in ("pod", "data") if a in names)
        axes = rules.MeshAxes(data=manual)
        n_dp, n_model = axes.sizes(mesh)
        dims = steps.scatter_dims_tree(shapes, n_dp, n_model)
        for mode in ("zero1", "fsdp"):
            pspecs = rules.param_specs(shapes, axes, mesh, mode)
            ospecs = steps.opt_specs(pspecs, dims, manual)
            want_p, want_d, want_o = _reference_specs(name, shape, names,
                                                      mode)
            tag = f"{name} {shape} {mode}"
            assert {k: tuple(v) for k, v in pspecs.items()} == want_p, tag
            assert dims == want_d, tag
            assert {k: tuple(v) for k, v in ospecs.items()} == want_o, tag
            assert any(d >= 0 for d in dims.values()), tag
            if mode == "fsdp":
                assert any(manual[-1] in str(s) for s in pspecs.values())


# -- the meshes and the shard cut over gloo ranks ----------------------------

def _rank(rank: int, out_dir: str) -> None:
    """One gloo rank at each world it belongs to: its meshes' layout,
    the production mesh's error, and a leaf cut and rebuilt."""
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.sharding import rules
    for world in WORLDS:
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{out_dir}/store-{world}",
            rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT))
        try:
            res = {}
            for model in (1, 2):
                if world % model:
                    try:
                        make_host_mesh(model, device="cpu")
                    except ValueError as e:
                        res[f"host{model}"] = {"error": str(e)}
                    continue
                m = make_host_mesh(model, device="cpu")
                res[f"host{model}"] = {
                    "shape": m.shape, "names": m.names,
                    "ranks": {n: m.axes[n].ranks for n in m.names}}
            for multi in (False, True):
                try:
                    make_production_mesh(multi_pod=multi, device="cpu")
                    res[f"production{multi}"] = {"error": None}
                except ValueError as e:
                    res[f"production{multi}"] = {"error": str(e)}
            if world == 4:
                mesh = compat.make_mesh((2, 2), ("pod", "data"),
                                        device="cpu")
                full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
                spec = rules.P(("pod", "data"), None)
                shard = rules.shard_of(full, spec, mesh)
                res["shard"] = shard.tolist()
                res["unshard"] = rules.unshard(shard, spec, mesh).tolist()
                res["shard_dim1"] = rules.shard_of(
                    full, rules.P(None, "data"), mesh).tolist()
            (Path(out_dir) / f"mesh-{world}-{rank}.json").write_text(
                json.dumps(res))
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("meshes")
    ctx = mp.start_processes(_rank, args=(str(out),), nprocs=max(WORLDS),
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return {w: [json.loads((out / f"mesh-{w}-{r}.json").read_text())
                for r in range(w)] for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_meshes_over_gloo_ranks(meshes, world):
    for rank, res in enumerate(meshes[world]):
        for model in (1, 2):
            got = res[f"host{model}"]
            if world % model:
                assert "does not divide" in got["error"]
                continue
            assert got["shape"] == [world // model, model]
            assert got["names"] == ["data", "model"]
            # row-major: rank = data * model + model index
            d, m = divmod(rank, model)
            assert got["ranks"]["data"] == [i * model + m
                                           for i in range(world // model)]
            assert got["ranks"]["model"] == [d * model + i
                                            for i in range(model)]
        for multi, n in ((False, 256), (True, 512)):
            err = res[f"production{multi}"]["error"]
            assert err and f"needs {n} ranks" in err and \
                f"has {world}" in err


def test_shard_of_is_pod_major_and_unshard_inverts(meshes):
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for rank, res in enumerate(meshes[4]):
        pod, data = divmod(rank, 2)
        # ("pod", "data") on dim 0: chunk pod * 2 + data of four
        assert np.array_equal(res["shard"], full[rank * 2:rank * 2 + 2])
        assert np.array_equal(res["unshard"], full)
        # "data" alone on dim 1: the data coordinate's half
        assert np.array_equal(res["shard_dim1"],
                              full[:, data * 3:data * 3 + 3])
