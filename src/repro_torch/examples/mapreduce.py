"""Distributed WordCount with in-network reduction (paper Figs. 16-18).

Mappers push (word, count) pairs through Map.addTo; the network holds the
running reduction in the INC map (switch registers + host spill); Query
reads the aggregate with Map.get. The AsyncAgtr type: arbitrary keys,
results readable at any time.

The typed schema says it all: ``ReduceByKey`` declares its kvs field as
an ``Agg`` stream (the in-network reduce), ``Query`` is ``ReadMostly``.
On a plain ``NetRPC`` the futures resolve inline — same API, no
scheduler — so ``.result()`` right after the call is the sync path.

The switch registers live on the card (every addTo is one launch of the
``sparse_addto`` kernel) unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.mapreduce [--device cpu]
"""
import argparse
import sys
from collections import Counter

import repro_torch.api as inc

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks and the fox runs",
    "in network computation makes the reduce free",
    "the network is the computer said the fox",
]


@inc.service(app="MR-1")
class MapReduce:
    @inc.rpc(request_msg="ReduceRequest")
    def ReduceByKey(self, kvs: inc.Agg[inc.STRINTMap]
                    ) -> {"msg": inc.Plain}: ...

    @inc.rpc(reply_msg="QueryReply")
    def Query(self, kvs: inc.ReadMostly[inc.STRINTMap]): ...


def main(argv=None, *, device=None) -> dict:
    """Two mappers reduce the corpus in-network; returns the reduced
    counts and the top 5 words."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args([] if argv is None else argv)

    rt = inc.NetRPC(device=args.device)
    mappers = [rt.make_stub(MapReduce) for _ in range(2)]

    # map phase: each mapper reduces its shard locally, pushes partials
    for i, m in enumerate(mappers):
        shard = CORPUS[i::2]
        local = Counter(w for line in shard for w in line.split())
        m.ReduceByKey(kvs=dict(local)).result()

    # query: read the global reduction out of the network
    truth = Counter(w for line in CORPUS for w in line.split())
    reply = mappers[0].Query(kvs={w: 0 for w in truth}).result()
    got = {k: int(v) for k, v in reply["kvs"].items()}
    top = sorted(got.items(), key=lambda kv: -kv[1])[:5]
    print("top words:", top)
    assert got == dict(truth), (got, dict(truth))
    print(f"== all {len(truth)} keys reduced in-network correctly")
    return {"counts": got, "top": top}


if __name__ == "__main__":
    main(sys.argv[1:])
