"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_all``) held
to the reference's and to PERF.md §3.

- The port's counted dot FLOPs of the reduced qwen2.5-3b's train step
  and prefill at one rank against ``repro.roofline.analysis.analyze`` of
  the reference's compiled program on one CPU device (measured gap: 0,
  the same products; HBM bytes differ: eager PyTorch does not fuse).
  ``model_flops`` and ``count_params`` equal exactly.
- The collectives over "model" on a fake world of 2 ranks at (1, 2): the
  reduced configs' decode step and train step make the all-reduces a
  layer that PERF.md §3 states.
- The CLI: a cell runs (``status: ok``), a cell ``shape_applicable``
  refuses is ``skipped``, and importing the port starts no world.
- A train cell under ``--flash`` (the reference's ``REPRO_FLASH_ATTN=1``)
  runs kernel 11 twice a flashed layer and microbatch (the forward and
  the checkpoint's recompute) and each backward kernel once; its other
  dot FLOPs are the plain lane's less the attention products, and its
  ``flash_traffic_bytes`` is the sum of the flash kernels' records, on
  the reduced config and at full size (``train_4k``) through the CLI.

Each fake world runs in a subprocess: its process group is process-wide.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
SEQ, BATCH = 64, 2
ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b", "gemma3-27b",
         "phi4-mini-3.8b", "stablelm-1.6b", "qwen2.5-3b",
         "llama-3.2-vision-90b", "recurrentgemma-9b", "mamba2-780m",
         "whisper-medium")
FLOPS_RTOL = 1e-6      # the measured gap is 0


def _child(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


ONE_RANK = f"""
import json
from repro_torch import compat
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.launch import dryrun
dryrun.fake_world(1)
mesh = compat.make_mesh((1, 1), ("data", "model"), device="meta")
cfg = get_arch("qwen2.5-3b").reduced()
out = {{}}
for kind, kw in (("train", dict(inc=IncAggConfig(mode="netrpc"),
                                n_micro=1)), ("prefill", {{}})):
    _, r, _ = dryrun.count_program(
        cfg, ShapeConfig("t", {SEQ}, {BATCH}, kind), mesh, **kw)
    out[kind] = r.flops
# the train step in 2 microbatches on each attention lane
from repro_torch.roofline.flash_model import flash_traffic_bytes
train = ShapeConfig("t", {SEQ}, {BATCH}, "train")
for flash in (False, True):
    _, r, _ = dryrun.count_program(cfg, train, mesh,
                                   inc=IncAggConfig(mode="netrpc"),
                                   n_micro=2, flash=flash)
    out["flash" if flash else "plain"] = {{"flops": r.flops,
                                          "kernels": r.kernels}}
out["flash_traffic_bytes"] = flash_traffic_bytes(cfg, train, n_dp=1,
                                                 n_model=1, n_micro=2)
print(json.dumps(out))
"""

TWO_RANKS = f"""
import json
from repro_torch import compat
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.launch import dryrun
dryrun.fake_world(2)
mesh = compat.make_mesh((1, 2), ("data", "model"), device="meta")
model = ",".join(map(str, mesh.axes["model"].ranks))
out = {{}}
for arch in {ARCHS!r}:
    cfg = get_arch(arch).reduced()
    row = {{}}
    for kind, kw in (("decode", {{}}),
                     ("train", dict(inc=IncAggConfig(mode="netrpc"),
                                    n_micro=1))):
        _, r, _ = dryrun.count_program(
            cfg, ShapeConfig("t", {SEQ}, {BATCH}, kind), mesh, **kw)
        row[kind] = r.calls.get("all-reduce", {{}}).get(model, 0)
    out[arch] = row
# xla-psum over two data ranks: the fake backend takes NCCL's lane, one
# reduce-scatter a scattered leaf (gloo's all-reduce and slice otherwise)
data = compat.make_mesh((2, 1), ("data", "model"), device="meta")
cfg = get_arch("qwen2.5-3b").reduced()
_, r, _ = dryrun.count_program(
    cfg, ShapeConfig("t", {SEQ}, {BATCH}, "train"), data,
    inc=IncAggConfig(mode="xla-psum"), n_micro=1)
out["xla-psum"] = {{k: sum(v.values()) for k, v in r.calls.items()}}
print(json.dumps(out))
"""


FLASH_CELL = ("--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh",
              "single", "--flash")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both fake worlds and the CLI's flash train cell, run side by
    side."""
    out = tmp_path_factory.mktemp("flash_cell") / "cell.json"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *FLASH_CELL,
         "--json", str(out)], env=dict(os.environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    one, two = _child(ONE_RANK), _child(TWO_RANKS)
    got = {"one": _result(one), "two": _result(two)}
    _, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    got["flash_cell"] = json.loads(out.read_text())
    return got


@pytest.fixture(scope="module")
def reference_flops():
    from repro import compat as jcompat
    from repro.configs.base import ShapeConfig as JShape, get_arch as jget
    from repro.core.inc_agg import IncAggConfig as JInc
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.roofline import analysis as ja
    jmesh = jcompat.make_mesh((1, 1), ("data", "model"))
    cfg = jget("qwen2.5-3b").reduced()
    out = {}
    for kind in ("train", "prefill"):
        shape = JShape("t", SEQ, BATCH, kind)
        if kind == "train":
            prog = jsteps.build_train_step(
                cfg, shape, jmesh, inc=JInc(mode="netrpc"), opt_cfg=JOpt(),
                n_micro=1, donate=False)
        else:
            prog = jsteps.build_serve_step(cfg, shape, jmesh)
        out[kind] = ja.analyze(prog.lower().compile()).flops
    return out


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dot_flops_match_the_reference(worlds, reference_flops, kind):
    want = reference_flops[kind]
    assert want > 0
    assert worlds["one"][kind] == pytest.approx(want, rel=FLOPS_RTOL)


FLASH_KERNELS = ("flash_attention", "flash_bwd_delta", "flash_bwd_dkdv",
                 "flash_bwd_dq")


def test_flash_train_cell_records_the_backward_kernels(worlds):
    """The reduced qwen2.5-3b's train step in 2 microbatches with
    ``flash=True``: 2 forward launches and 1 of each backward kernel a
    flashed layer and microbatch; its other dot FLOPs equal the plain
    lane's less the attention products (S < CHUNKED_THRESHOLD: dense QK^T
    and PV, forward, recompute and their 4 backward products, each 2 B H
    S^2 D); ``flash_traffic_bytes`` is the sum of the records' bytes."""
    from repro_torch.configs.base import get_arch
    from repro_torch.roofline.flash_model import flashed_layers
    cfg = get_arch("qwen2.5-3b").reduced()
    one = worlds["one"]
    kernels = one["flash"]["kernels"]
    layers = sum(flashed_layers(cfg, SEQ))
    assert layers == cfg.n_layers
    assert {n: kernels[n]["launches"] for n in FLASH_KERNELS} == {
        "flash_attention": 2 * layers * 2, "flash_bwd_delta": layers * 2,
        "flash_bwd_dkdv": layers * 2, "flash_bwd_dq": layers * 2}
    assert not any(n.startswith("flash") for n in one["plain"]["kernels"])
    attention = 8 * 2 * BATCH * cfg.n_heads * SEQ * SEQ * cfg.hd * layers
    kernel_flops = sum(kernels[n]["flops"] for n in FLASH_KERNELS)
    assert one["flash"]["flops"] - kernel_flops \
        == one["plain"]["flops"] - attention
    assert one["flash_traffic_bytes"] == sum(kernels[n]["bytes"]
                                             for n in FLASH_KERNELS) > 0


def test_cli_flash_train_cell_reports_its_flash_traffic(worlds):
    """``--flash`` on a full-size train cell (qwen2.5-3b, train_4k, rank 0
    of the (16, 16) mesh: 36 flashed layers, its microbatches) reports a
    nonzero flash traffic term, the sum of the kernels' records."""
    res = worlds["flash_cell"]
    assert res["status"] == "ok" and res["flash"] and res["kind"] == "train"
    kernels = res["kernels"]
    n = 36 * res["n_micro"]
    assert [kernels[k]["launches"] for k in FLASH_KERNELS] == [2 * n, n, n,
                                                             n]
    assert res["flash_traffic_bytes"] == sum(kernels[k]["bytes"]
                                             for k in FLASH_KERNELS) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_params_equal_the_reference(arch):
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro.roofline import analysis as ja

    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.roofline import analysis
    for reduce in (False, True):
        cfg, jcfg = get_arch(arch), jget(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        n, active = api.count_params(cfg), api.count_params(cfg, True)
        assert n == japi.count_params(jcfg)
        assert active == japi.count_params(jcfg, active_only=True)
        for kind, tokens in (("train", 256 * 4096), ("decode", 128)):
            assert analysis.model_flops(n, active, kind, tokens) \
                == ja.model_flops(n, active, kind, tokens)


# PERF.md §3: all-reduces over "model" of one cut layer. A decode step:
# 2 (after wo and w2, or w_out), 3 in selfcross (wo, the cross wo, w2).
# A train microbatch: the forward's 2 (3 in selfcross), again in the
# checkpoint's recompute, and the backward's sums of the cut products'
# input gradients: 5 for attention and a SwiGLU (q, k, v, w1, w3), the
# experts' w1 and w3 in moe; 4 in rglru (its two input columns, w1, w3);
# 6 in ssd (z, x, dt, B and C's to_model, the norm's sum); 7 in selfcross
# (q, k, v, the cross q, the memory's K and V, the GELU MLP's w1); 5 in
# cross (its q, the memory's K and V, w1, w3); whole wk/wv (a rank's
# query heads read a KV head whole: MQA) add their two weight gradients'
# sums. The encoder's bidir layers are not recomputed: 2 + 4 (q, k, v,
# w1). A VLM's mproj sums its input gradient once a microbatch.
DECODE = {"global": 2, "local": 2, "moe": 2, "rglru": 2, "ssd": 2,
          "cross": 2, "selfcross": 3}
TRAIN = {"global": 9, "local": 9, "moe": 9, "rglru": 8, "ssd": 10,
         "cross": 9, "selfcross": 13}
BIDIR_TRAIN = 6


def _expected(arch: str, kind: str) -> int:
    from repro_torch.configs.base import get_arch
    from repro_torch.sharding import tp
    cfg = get_arch(arch).reduced()
    # a step: the vocab-parallel lookup's sum; to train also the logits'
    # backward (a microbatch) and the global norm's sum over "model"
    n = 1 if kind == "decode" else 3
    per = DECODE if kind == "decode" else TRAIN
    whole_kv = cfg.n_heads and tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, 2,
                                           0)[1] == cfg.n_kv_heads
    for pat, reps in cfg.pattern_groups:
        for bt in pat:
            n += reps * per[bt]
            if kind == "train" and whole_kv and bt in ("global", "local"):
                n += reps * 2
        # the checkpoint's recompute of a unit stops at the last tensor
        # its backward saves: the final w2's sum is not redone, unless
        # a moe combine after it keeps its output
        if kind == "train" and pat[-1] != "moe":
            n -= reps
    if kind == "train":
        n += cfg.enc_layers * BIDIR_TRAIN + (cfg.family == "vlm")
    return n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["decode", "train"])
def test_all_reduces_over_model_a_layer(worlds, arch, kind):
    assert worlds["two"][arch][kind] == _expected(arch, kind)


def test_fake_world_takes_the_reduce_scatter_lane(worlds):
    """On the fake backend (the dry run's stand-in for NCCL) the xla-psum
    step reduce-scatters each scattered leaf, as NCCL does, instead of
    gloo's all-reduce and slice."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import api
    dims = steps.scatter_dims_tree(
        api.param_shapes(get_arch("qwen2.5-3b").reduced()), 2, 1)
    calls = worlds["two"]["xla-psum"]
    assert calls["reduce-scatter"] == sum(d >= 0 for d in dims.values())


def _cli(*args: str) -> tuple[int, dict]:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("DRYRUN_RESULT ")]
    return out.returncode, (json.loads(line[-1].split(" ", 1)[1])
                            if line else {"stdout": out.stdout,
                                          "stderr": out.stderr[-3000:]})


def test_cli_runs_a_cell_on_the_production_mesh():
    rc, res = _cli("repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
                   "--shape", "decode_32k", "--mesh", "single")
    assert rc == 0 and res["status"] == "ok", res
    assert res["chips"] == 256 and res["kind"] == "decode"
    # 2 all-reduces a layer over "model" and the lookup's (PERF.md §3)
    assert res["calls"]["all-reduce"][",".join(map(str, range(16)))] \
        == 36 * 2 + 1
    assert res["fits"] and 0 < res["arg_bytes"] <= res["peak_bytes"]
    assert res["flops_per_dev"] > 0 and res["hbm_bytes_per_dev"] > 0
    assert res["dominant"] in ("compute", "memory", "collective")


def test_cli_skips_a_cell_the_shape_refuses(tmp_path):
    rc, res = _cli("repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
                   "--shape", "long_500k", "--mesh", "multi")
    assert rc == 0 and res["status"] == "skipped" and res["why"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_all", "--arch",
         "whisper-medium", "--shape", "long_500k", "--mesh", "single",
         "multi", "--outdir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2/2 cells ok/skipped; 0 failed" in out.stdout
    assert len(list(tmp_path.glob("whisper-medium__long_500k__*.json"))) \
        == 2


def test_importing_the_port_starts_no_world():
    code = ("import importlib, pkgutil, repro_torch\n"
            "import torch.distributed as dist\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'): importlib.import_module(m.name)\n"
            "print(dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"
