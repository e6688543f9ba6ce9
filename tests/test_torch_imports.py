"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package, and its entry points default to the card."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax_or_repro():
    names = _modules()
    assert {"repro_torch.kernels.fused_gpv", "repro_torch.core.runtime",
            "repro_torch.api", "repro_torch.quickstart",
            "repro_torch.compat", "repro_torch.core.inc_agg",
            "repro_torch.core.ring", "repro_torch.kernels.quantize",
            "repro_torch.models.api", "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attn", "repro_torch.launch.mesh",
            "repro_torch.sharding.rules"} \
        <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["SwitchMemory", "Controller", "NetRPC",
                                   "IncRuntime"])
def test_entry_points_default_to_the_card(entry):
    from repro_torch.core.channel import Controller
    from repro_torch.core.inc_map import SwitchMemory
    from repro_torch.core.rpc import NetRPC
    from repro_torch.core.runtime import IncRuntime
    cls = {"SwitchMemory": SwitchMemory, "Controller": Controller,
           "NetRPC": NetRPC, "IncRuntime": IncRuntime}[entry]
    if torch.cuda.is_available():
        obj = cls()
        sw = getattr(obj, "controller", obj)
        assert getattr(sw, "switch", sw).device.type == "cuda"
        if hasattr(obj, "close"):
            obj.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    obj = cls(device="cpu")
    sw = getattr(obj, "controller", obj)
    assert getattr(sw, "switch", sw).device.type == "cpu"
    if hasattr(obj, "close"):
        obj.close()


def test_make_mesh_defaults_to_the_card():
    """compat.make_mesh means NCCL on the card unless given device='cpu'
    (gloo); without a card the default raises before any group exists."""
    from repro_torch import compat
    # with a card the default passes the device check and stops at the
    # missing process group, like device='cpu' does
    with pytest.raises(RuntimeError, match="init_process_group"
                       if torch.cuda.is_available() else "device='cpu'"):
        compat.make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="init_process_group"):
        compat.make_mesh((1,), ("data",), device="cpu")
