"""Map.clear policies (paper §5.2.2, Table 6).

The switch memory only supports addTo, not overwrite, so starting a new
accumulation round requires get + clear + addTo. The pipeline
(core/rpc.py) reads ``POLICIES`` to decide whether a Map.get writes its
clear back; the copy / shadow / lazy accumulator classes come with the
saturating-add kernel in a later slice of the port.
"""

POLICIES = ("copy", "shadow", "lazy")
