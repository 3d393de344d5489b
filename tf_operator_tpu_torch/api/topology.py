"""Slice topology arithmetic: a copy of the schema-level helpers of
`tf_operator_tpu/api/types.py` (re-exported by `runtime/slices.py`), which
the multislice check needs to know how many hosts (processes) a slice of a
topology string spans.  The values must stay the JAX package's, since the
same controller packs replicas into slices by them."""
from __future__ import annotations

from typing import Tuple

# A host of a TPU pod slice carries 4 chips (v4: 2x2x1 per host; v5e/v5p:
# 4 chips/host).  Topologies with <=4 chips fit on one host.
CHIPS_PER_HOST = 4


def parse_topology(topology: str) -> Tuple[int, ...]:
    """'4x8' -> (4, 8); '2x2x2' -> (2, 2, 2).  Raises ValueError on junk."""
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError:
        raise ValueError(f"malformed slice topology {topology!r}")
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"malformed slice topology {topology!r}")
    return dims


def topology_chips(topology: str) -> int:
    chips = 1
    for d in parse_topology(topology):
        chips *= d
    return chips


def topology_hosts(topology: str) -> int:
    """Hosts (= worker processes) a slice of this shape spans."""
    return max(1, -(-topology_chips(topology) // CHIPS_PER_HOST))
