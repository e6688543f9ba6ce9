"""Paxos with in-network vote counting (paper §6.3, Fig. 7; Appendix D).

The leader and vote-counting functions are offloaded to the INC layer:
acceptors' Phase-2 accepts are counted by CntFwd, and learners are notified
only when a ballot reaches its majority — the server (learners) never see
sub-majority traffic (the sub-RTT latency optimization).

One typed service spans two channels: each RPC pins its own ``app=``, so
Phase 1 (test&set leader election = CntFwd threshold 1) and Phase 2
(majority counting) get separate switch partitions.  The ``kvs`` field is
a bare ``STRINTMap`` IEDT — it rides the INC channel (the ballot id tags
the vote counter) and never reaches the learner handler.

The vote counters live on the card (every vote is one launch of the
``sparse_addto`` kernel) unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.paxos [--proposals 50] \\
        [--device cpu]
"""
import argparse
import sys
import time

import numpy as np

import repro_torch.api as inc

N_ACCEPTORS = 3
MAJORITY = 2


@inc.service(name="Paxos")
class Paxos:
    # Phase 1 (prepare/promise): test&set on the ballot number -> the
    # in-network leader election (threshold=1 CntFwd = test&set).
    @inc.rpc(app="paxos-prepare",
             cnt_fwd=inc.CntFwd(to="SRC", threshold=1, key="kvs"))
    def Prepare(self, kvs: inc.STRINTMap) -> {"msg": inc.Plain}: ...

    # Phase 2 (accept): count accepts; forward to learners at majority.
    @inc.rpc(app="paxos-accept",
             cnt_fwd=inc.CntFwd(to="ALL", threshold=MAJORITY, key="kvs"))
    def Accept(self, kvs: inc.STRINTMap) -> {"msg": inc.Plain}: ...


def main(argv=None, *, device=None) -> dict:
    """``--proposals`` ballots, each elected and then accepted by
    N_ACCEPTORS; returns the commits of each ballot, the learner's
    message count, the throughput and the commit p50/p99 (seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proposals", type=int, default=50)
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args([] if argv is None else argv)

    rt = inc.NetRPC(device=args.device)
    learned = []
    rt.server.register("Accept",
                       lambda req: learned.append(req) or {"msg": "learned"})
    rt.server.register("Prepare", lambda req: {"msg": "promise"})

    acceptors = [rt.make_stub(Paxos) for _ in range(N_ACCEPTORS)]

    lat = []
    commits = []
    t0 = time.time()
    for ballot in range(args.proposals):
        # proposer wins Phase 1 in-network (first test&set wins)
        r = acceptors[0].Prepare(kvs={f"b{ballot}": 1}).result()
        assert r.get("msg") == "promise"
        # acceptors cast Phase-2 accepts; learners notified at majority
        t1 = time.perf_counter()
        committed = 0
        for i, a in enumerate(acceptors):
            out = a.Accept(kvs={f"b{ballot}": 1}).result()
            if out.get("msg") == "learned":
                committed += 1
                lat.append(time.perf_counter() - t1)
        assert committed == 1, "exactly one majority notification"
        commits.append(committed)
    dt = time.time() - t0
    thr = args.proposals / dt
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"consensus throughput: {thr:.0f} proposals/s; "
          f"p50 commit latency {p50 * 1e6:.0f}us; "
          f"p99 {p99 * 1e6:.0f}us")
    print(f"learner saw {len(learned)} messages for {args.proposals} "
          f"proposals (sub-majority traffic dropped in-network)")
    return {"commits": commits, "learned": len(learned),
            "proposals_per_s": thr, "commit_p50_s": float(p50),
            "commit_p99_s": float(p99)}


if __name__ == "__main__":
    main(sys.argv[1:])
