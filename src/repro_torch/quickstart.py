"""Quickstart: an INC-accelerated RPC on the card (paper Figs. 2-4).

The typed declarative schema is the user's entire "switch program":
``Agg[FPArray](precision=8, clear="copy", device=True)`` says "this
tensor is summed in-network at 8 fixed-point digits, the map is cleared
after each aggregation round, and the registers live on the device"; the
``CntFwd`` option says "reply only once 2 clients contributed".

Every invocation returns an ``IncFuture``; the runtime's auto-drain
scheduler coalesces the two workers' calls (they share the DT-1 channel)
into ONE pipeline batch. The reply is an fp32 tensor on the card.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

import repro_torch.api as inc


@inc.service(app="DT-1",
             drain=inc.DrainPolicy(max_batch=2, max_delay=0.05,
                                   eager_window=False))
class Gradient:
    @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad",
             cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="ClientID"))
    def Update(self, tensor: inc.Agg[inc.FPArray](precision=8,
                                                  clear="copy",
                                                  device=True)
               ) -> {"tensor": inc.Get[inc.FPArray]}: ...


def main(device=None):
    runtime = inc.IncRuntime(device=device)
    worker_a = runtime.make_stub(Gradient)
    worker_b = runtime.make_stub(Gradient)

    grad_a = np.array([0.125, -1.5, 3.25, 0.0], np.float32)
    grad_b = np.array([1.0, 0.5, -0.25, 2.0], np.float32)
    want = (grad_a + grad_b).astype(np.float64)

    f_a = worker_a.Update(tensor=grad_a)
    f_b = worker_b.Update(tensor=grad_b)
    print("worker A reply (below threshold, dropped in-network):",
          f_a.result())
    agg = f_b.result()["tensor"]
    print("worker B reply (aggregated):", agg)
    assert isinstance(agg, torch.Tensor) and agg.dtype == torch.float32
    assert agg.device.type == runtime.controller.switch.device.type
    assert tuple(agg.shape) == grad_a.shape
    assert np.allclose(agg.cpu().numpy(), want, atol=1e-6)
    ch = worker_a.channels["Update"]
    print(f"auto-drained {ch.stats.drained_calls} calls in "
          f"{ch.stats.drained_batches} channel batch "
          f"(triggers: {ch.stats.drain_triggers})")
    assert ch.stats.drained_batches == 1
    print("== in-network sum matches", want.tolist())

    r1 = worker_a.Update(tensor=grad_a).result()
    r2 = worker_b.Update(tensor=grad_b).result()
    assert r1 == {} and np.allclose(r2["tensor"].cpu().numpy(), want,
                                    atol=1e-6)
    print("== sequential .result() round agrees")
    runtime.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(ap.parse_args().device)
