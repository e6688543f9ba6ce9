"""The RPC front of both packages under one set of names, for the port's
differential mirrors (``tests/test_torch_{schema,runtime_async,obs,
runtime_shard,wire_path,front,local_accum}.py``).

``port()`` is ``repro_torch`` with every runtime, controller and register
file made on ``device="cpu"`` unless the caller names a device; ``ref()``
is the JAX package, imported only when called (the card's machine has no
JAX). Both return a ``Front`` whose attributes name the same objects in
either package, so a test body written once against ``pk.<name>`` runs
on each, and the test compares what the two runs return with ``same``.
"""
import functools
import types

import numpy as np


class Front(types.SimpleNamespace):
    """One package's front: modules and classes under shared names."""


def _on(device, make):
    """``make`` with ``device=`` defaulted to ``device``."""
    @functools.wraps(make)
    def made(*a, **kw):
        kw.setdefault("device", device)
        return make(*a, **kw)
    return made


@functools.lru_cache(maxsize=None)
def ref() -> Front:
    import repro.api as inc
    from repro import obs
    from repro.core import channel, inc_map, netfilter, rpc, runtime
    from repro.kernels import constants, ops
    from repro.obs import metrics, schema, trace
    return _front("jax", inc, obs, channel, inc_map, netfilter, rpc,
                  runtime, constants, ops, metrics, schema, trace,
                  device=None)


@functools.lru_cache(maxsize=None)
def port(device: str = "cpu") -> Front:
    import repro_torch.api as inc
    from repro_torch import obs
    from repro_torch.core import channel, inc_map, netfilter, rpc, runtime
    from repro_torch.kernels import constants, ops
    from repro_torch.obs import metrics, schema, trace
    return _front("torch", inc, obs, channel, inc_map, netfilter, rpc,
                  runtime, constants, ops, metrics, schema, trace,
                  device=device)


def _front(name, inc, obs, channel, inc_map, netfilter, rpc, runtime,
           constants, ops, metrics, schema, trace, device) -> Front:
    def on(make):
        return make if device is None else _on(device, make)
    return Front(
        name=name, inc=inc, obs=obs, channel=channel, inc_map=inc_map,
        rpc=rpc, runtime=runtime, constants=constants, ops=ops,
        metrics=metrics, obs_schema=schema, trace=trace,
        NetFilter=netfilter.NetFilter, CntFwdSpec=netfilter.CntFwdSpec,
        Field=rpc.Field, Service=rpc.Service,
        TensorSegment=rpc.TensorSegment, DrainPolicy=runtime.DrainPolicy,
        NetRPC=on(rpc.NetRPC), IncRuntime=on(runtime.IncRuntime),
        Controller=on(channel.Controller),
        SwitchMemory=on(inc_map.SwitchMemory),
        ServerAgent=inc_map.ServerAgent, ClientAgent=inc_map.ClientAgent)


def examples(pk: Front) -> dict:
    """The four example services' classes of ``pk``'s package, by name."""
    if pk.name == "jax":
        from examples.mapreduce import MapReduce
        from examples.monitoring import Monitor
        from examples.paxos import Paxos
        from examples.quickstart import Gradient
    else:
        from repro_torch.examples.mapreduce import MapReduce
        from repro_torch.examples.monitoring import Monitor
        from repro_torch.examples.paxos import Paxos
        from repro_torch.quickstart import Gradient
    return {"Gradient": Gradient, "Monitor": Monitor,
            "MapReduce": MapReduce, "Paxos": Paxos}


def both():
    """(reference, port): the order every mirror runs them in."""
    return ref(), port()


def plain(x):
    """``x`` with every array (numpy, jax or torch) as a numpy array and
    every container rebuilt, so the two packages' results compare with
    ``same``."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if type(x).__module__.startswith("torch"):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.generic):
        return np.asarray(x)
    return x


def same(a, b, path="$") -> None:
    """Asserts ``a`` and ``b`` equal after ``plain``: arrays of one dtype
    and shape, bit for bit; dicts key for key; scalars by ``==`` and type
    class (an int is not a float)."""
    a, b = plain(a), plain(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), \
            (path, type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (path, a, b)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, a.keys() if isinstance(a, dict) else a, b)
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, float) and isinstance(b, float) \
            and np.isnan(a) and np.isnan(b):
        return
    assert a == b and isinstance(a, bool) == isinstance(b, bool) \
        and isinstance(a, float) == isinstance(b, float), (path, a, b)


def mirror(body, *args, **kw):
    """``body(pk, *args, **kw)`` on the reference, then on the port;
    asserts the two results equal (``same``) and returns the port's."""
    want = body(ref(), *args, **kw)
    got = body(port(), *args, **kw)
    same(got, want)
    return got


# fields of ``scheduling_report()`` and ``metrics_snapshot()`` that follow
# the host's clock or its thread scheduling: wall-clock waits and
# latencies, the simulated ingress queue and the AIMD window it drives,
# queue peaks and admission waits, which worker took a drain. A
# cross-package comparison leaves them out (``untimed``)
TIMED_KEYS = frozenset({"occupancy", "cw", "ecn_marks", "max_queue_depth",
                        "pick_contention", "deficit", "workers"})


def timed(key) -> bool:
    return isinstance(key, str) and (key in TIMED_KEYS or "wait" in key
                                     or key.endswith("_us")
                                     or "_us{" in key)


def untimed(x):
    """``x`` (a report or snapshot) without its ``timed`` fields, at any
    depth."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if not timed(k)}
    if isinstance(x, (list, tuple)):
        return type(x)(untimed(v) for v in x)
    return x
