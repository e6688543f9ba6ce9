"""repro_torch.api — the NetRPC front door, in one import.

    import repro_torch.api as inc

    @inc.service(app="DT-1")
    class Gradient:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad",
                 cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="ClientID"))
        def Update(self, tensor: inc.Agg[inc.FPArray](precision=8,
                                                      clear="copy")
                   ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    with inc.IncRuntime() as rt:
        stub = rt.make_stub(Gradient)
        reply = stub.Update(tensor=grad).result()

Everything a NetRPC application touches lives here: the declarative
schema vocabulary (``service``/``rpc`` decorators, ``Agg``/``Get``/
``ReadMostly`` field annotations, IEDT markers, ``CntFwd``), the
runtimes (``IncRuntime`` with the auto-drain scheduler, plain ``NetRPC``
for inline execution) and their ``DrainPolicy`` knobs, and ``IncFuture``
— the unified completion handle every invocation returns.

The legacy string-keyed surface (``Service``/``Field``/``NetFilter`` +
``Stub.call``/``call_batch``) is re-exported as the compatibility shim
the schema layer compiles down to; new code should not need it.

Observability (``repro_torch.obs``, docs/OBSERVABILITY.md) rides along:
``inc.obs.enable()`` turns the data-plane metrics/tracing on,
``inc.metrics()`` is the process-wide registry for application metrics,
and ``inc.trace("span")`` opens a user span on the exported timeline.
"""
from repro_torch import obs
from repro_torch.core.netfilter import NetFilter
from repro_torch.core.rpc import Field, IncFuture, NetRPC, Service, Stub
from repro_torch.core.runtime import DrainPolicy, IncRuntime
from repro_torch.core.schema import (Agg, BoundRpc, CntFwd, FPArray, Get,
                                     IntArray, Integer, Plain, ReadMostly,
                                     STRINTMap, SchemaError, ServiceSchema,
                                     TypedStub, compile_service, rpc, service)

__all__ = [
    # schema vocabulary
    "service", "rpc", "Agg", "Get", "ReadMostly", "CntFwd", "Plain",
    "FPArray", "IntArray", "STRINTMap", "Integer",
    "compile_service", "SchemaError", "ServiceSchema", "TypedStub",
    "BoundRpc",
    # runtimes + futures
    "IncRuntime", "NetRPC", "DrainPolicy", "IncFuture",
    # observability front door
    "obs", "metrics", "trace",
    # legacy compatibility shim
    "Service", "Field", "Stub", "NetFilter",
]


def metrics():
    """The process-wide metrics registry (``repro_torch.obs``): get-or-create
    handles via ``inc.metrics().counter("name", **labels)`` / ``gauge`` /
    ``histogram``. Recording is a no-op until ``inc.obs.enable()``."""
    return obs.registry()


def trace(name: str, **args):
    """User span on the exported timeline::

        with inc.trace("train_step", step=i):
            ...

    No-op unless tracing is on (``inc.obs.enable(trace=True)``)."""
    return obs.trace_span(name, **args)
