"""The link-bandwidth model: named profiles + α-β algebra (the port of
``repro/core/linkmodel.py``).

MiCS's central claim is that the *right* communication scale depends on the
network (paper §3): heterogeneous bandwidth — fast intra-node links (NVLink)
vs slow inter-node links (EFA) — decides whether a flat, 2-stage inner-first,
or paper-faithful 3-stage outer-first gather wins.  The autotuner
(``core/autotune.py``) costs candidate ``GatherPolicy`` / ``SyncPolicy``
combinations with :meth:`LinkProfile.ring_time` over one of these tables,
and the memory planner (``core/memplan.py``) reads a profile's
``hbm_bytes`` for the serve residency.

A profile is a two-tier model: ``intra`` (the fast tier every group of up
to ``node_size`` consecutive ranks shares) and ``inter`` (the slow tier any
larger or node-crossing group pays), each an (α, β) pair — per-hop startup
latency plus per-participant ring bandwidth.  A third, non-network tier
prices the device <-> host link (PCIe): the ``host`` Link costs the d2h /
h2d streams of ``carry_offload='host'`` and ``offload_opt=True``
(``core/hostoffload.py``) as point-to-point transfers, ``alpha + n /
bandwidth`` (:meth:`LinkProfile.xfer_time`).

The tables are the reference's two clusters of the paper (``efa-100g``,
``efa-400g``) and one of the card the port runs on (``h100-p5``, the
default).  The reference's TPU table (``v5e``) is not carried: its
constants are a TPU's.

Units: bandwidths are bytes/second, latencies seconds.  Network-style
"Gbps" figures convert via :func:`gbps`.  The module imports nothing.
"""

from __future__ import annotations

import dataclasses

GB = 1e9
GIB = 1024**3


def gbps(gigabits_per_second: float) -> float:
    """Network-convention Gbit/s -> bytes/s (100 Gbps EFA = 12.5 GB/s)."""
    return gigabits_per_second * 1e9 / 8


@dataclasses.dataclass(frozen=True)
class Link:
    """One tier of the network: per-participant ring bandwidth + startup.

    ``bandwidth`` is the sustained bytes/s each participant of a ring
    collective moves on this tier; ``alpha`` is the per-hop startup latency
    (the (g-1)·α term of the standard α-β collective model).
    """

    bandwidth: float
    alpha: float


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Named two-tier link table + the chip roofline constants.

    intra:      fast tier (NVLink) — groups within one "node"
    inter:      slow tier (EFA)    — any group crossing node boundaries
    node_size:  consecutive ranks sharing the fast tier (paper's k)
    local_copy_bw: device-local copy bandwidth (the outer-first reorder stage)
    peak_flops / hbm_bw / hbm_bytes: chip constants for roofline synthesis
    """

    name: str
    intra: Link
    inter: Link
    node_size: int
    local_copy_bw: float
    peak_flops: float
    hbm_bw: float
    hbm_bytes: int
    description: str = ""
    # device<->host (PCIe) tier; None falls back to DEFAULT_HOST_LINK
    host: Link | None = None

    def __post_init__(self):
        if self.node_size < 1:
            raise ValueError(f"node_size must be >= 1, got {self.node_size}")
        tiers = (self.intra, self.inter) + (
            (self.host,) if self.host is not None else ())
        for tier in tiers:
            if tier.bandwidth <= 0:
                raise ValueError(f"{self.name}: non-positive bandwidth")

    # -- tier lookup --------------------------------------------------------
    def link(self, tier: str) -> Link:
        if tier == "intra":
            return self.intra
        if tier == "inter":
            return self.inter
        if tier == "host":
            return self.host if self.host is not None else DEFAULT_HOST_LINK
        raise ValueError(f"unknown tier {tier!r}")

    def group_tier(self, positions) -> str:
        """Tier of a ring over partition-group linear ``positions``: 'intra'
        iff every participant lies in the same node_size-aligned island."""
        islands = {p // self.node_size for p in positions}
        return "intra" if len(islands) <= 1 else "inter"

    # -- alpha-beta algebra -------------------------------------------------
    def ring_time(self, tier: str, group_size: int, wire_bytes: float) -> float:
        """Time of one ring collective stage that moves ``wire_bytes`` per
        participant over ``tier`` in ``group_size - 1`` hops.

        ``wire_bytes`` is the census convention: (g-1)/g of the full buffer
        for an all-gather / reduce-scatter stage, 2(g-1)/g for an
        all-reduce — so model and measurement share units.
        """
        if group_size <= 1 or wire_bytes <= 0:
            return 0.0
        link = self.link(tier)
        return (group_size - 1) * link.alpha + wire_bytes / link.bandwidth

    def copy_time(self, nbytes: float) -> float:
        """Device-local copy (the paper's Fig-5 chunk-reorder stage)."""
        return nbytes / self.local_copy_bw

    def xfer_time(self, tier: str, nbytes: float, events: int = 1) -> float:
        """Point-to-point stream time: ``events`` transfers totalling
        ``nbytes`` over ``tier`` — the host-tier unit (one α per d2h/h2d
        issue, no ring factor; each device owns its own PCIe lane)."""
        if nbytes <= 0 and events <= 0:
            return 0.0
        link = self.link(tier)
        return events * link.alpha + nbytes / link.bandwidth

    def hbm_time(self, nbytes: float) -> float:
        """Time to stream ``nbytes`` through HBM — the unit the cost model
        prices memory-bound boundary compute in: the hop-2 pipeline's
        hideable norm/decompress work (``autotune.cost_hop2_schedule``) and
        the int8 wire's per-stage quantize/dequantize overhead
        (``autotune.QGZ_COMPUTE_BYTES_PER_ELEM``)."""
        return nbytes / self.hbm_bw


# ---------------------------------------------------------------------------
# named profiles
# ---------------------------------------------------------------------------

# Fallback device<->host link for profiles that do not pin one: one PCIe3
# x16-class lane per device (~16 GB/s sustained), ~5 µs per DMA issue.
DEFAULT_HOST_LINK = Link(bandwidth=16 * GB, alpha=5e-6)

# AWS p3dn.24xlarge (the paper's measured cluster): 8 V100s per node on
# NVLink (B_part ~= 128 GB/s aggregate -> 16 GB/s per GPU rail), 100 Gbps
# EFA between nodes.  Alphas are the reference's calibration anchors.
EFA_100G = LinkProfile(
    name="efa-100g",
    intra=Link(bandwidth=16 * GB, alpha=8e-6),
    inter=Link(bandwidth=gbps(100), alpha=30e-6),
    node_size=8,
    local_copy_bw=900 * GB,
    peak_flops=125e12,                 # V100 fp16 tensor-core peak
    hbm_bw=900 * GB,
    hbm_bytes=32 * GIB,
    description="AWS p3dn: 8xV100 NVLink nodes, 100 Gbps EFA (paper anchor)",
    host=Link(bandwidth=16 * GB, alpha=5e-6),   # PCIe3 x16 per GPU
)

# AWS p4d.24xlarge-style follow-on: same node shape, 400 Gbps EFA.
EFA_400G = LinkProfile(
    name="efa-400g",
    intra=Link(bandwidth=16 * GB, alpha=8e-6),
    inter=Link(bandwidth=gbps(400), alpha=30e-6),
    node_size=8,
    local_copy_bw=900 * GB,
    peak_flops=312e12,                 # A100 bf16 peak
    hbm_bw=1555 * GB,
    hbm_bytes=40 * GIB,
    description="AWS p4d-style: NVLink nodes, 400 Gbps EFA",
    host=Link(bandwidth=32 * GB, alpha=5e-6),   # PCIe4 x16 per GPU
)

# The card the port runs on, in the node of AWS's published p5.48xlarge
# spec: 8 x H100 SXM 80GB a node on NVLink 4 (900 GB/s bidirectional a GPU:
# 450 GB/s each way) and 3,200 Gbps of EFA a node (400 Gbps a GPU).  HBM 80
# GB at 3.35 TB/s and 989 TFLOP/s dense bf16 are the figures the port's
# other code uses (core/topology.py, chip_smoke.py).  The host link is
# PCIe Gen5 x16 (64 GB/s each way on paper) at the card's own fits: pinned
# copies of 64 MiB and 1 GiB on an NVIDIA H100 80GB HBM3, 700.00 W read
# 54.99-55.25 GB/s to the host on four hosts, and back 55.34 and 55.48 on
# two, 49.19 and 48.16 on the other two (chip_smoke.py's host_link, which
# holds this tier within 10% of each way's fit).  The tier takes 51.7 GB/s,
# the geometric middle of those fits, within 7.3% of each.  The alphas are
# the EFA profiles' anchors: no latency of a p5 node was measured.
H100_P5 = LinkProfile(
    name="h100-p5",
    intra=Link(bandwidth=450 * GB, alpha=8e-6),
    inter=Link(bandwidth=gbps(400), alpha=30e-6),
    node_size=8,
    local_copy_bw=3.35e12,
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    description=("AWS p5.48xlarge (published spec): 8 x H100 SXM 80GB on NVLink 4 "
                 "(450 GB/s a GPU each way), 3,200 Gbps EFA a node (400 Gbps a GPU), "
                 "host PCIe Gen5 x16"),
    host=Link(bandwidth=51.7 * GB, alpha=5e-6),
)

# The profile MiCSConfig names by default.
DEFAULT_PROFILE = H100_P5.name

PROFILES: dict[str, LinkProfile] = {
    p.name: p for p in (EFA_100G, EFA_400G, H100_P5)
}


def register_profile(profile: LinkProfile) -> LinkProfile:
    """Add a profile to the named table (tests, site-specific clusters)."""
    PROFILES[profile.name] = profile
    return profile


def get_profile(profile: str | LinkProfile) -> LinkProfile:
    """Resolve a profile by name or pass an instance through."""
    if isinstance(profile, LinkProfile):
        return profile
    try:
        return PROFILES[profile]
    except KeyError:
        raise KeyError(
            f"unknown link profile {profile!r}; known: {sorted(PROFILES)} "
            f"(register_profile() adds custom tables)"
        ) from None


def custom_profile(
    name: str,
    *,
    intra_bw: float,
    inter_bw: float,
    node_size: int,
    alpha_intra: float = H100_P5.intra.alpha,
    alpha_inter: float = H100_P5.inter.alpha,
    host_bw: float | None = None,
    alpha_host: float = H100_P5.host.alpha,
    local_copy_bw: float = H100_P5.local_copy_bw,
    peak_flops: float = H100_P5.peak_flops,
    hbm_bw: float = H100_P5.hbm_bw,
    hbm_bytes: int = H100_P5.hbm_bytes,
    description: str = "",
    register: bool = False,
) -> LinkProfile:
    """Custom link-table constructor (bandwidths in bytes/s; use
    :func:`gbps` for network-style Gbit/s figures).  The defaults are the
    card's profile's fields."""
    p = LinkProfile(
        name=name,
        intra=Link(bandwidth=intra_bw, alpha=alpha_intra),
        inter=Link(bandwidth=inter_bw, alpha=alpha_inter),
        host=(Link(bandwidth=host_bw, alpha=alpha_host)
              if host_bw is not None else None),
        node_size=node_size,
        local_copy_bw=local_copy_bw,
        peak_flops=peak_flops,
        hbm_bw=hbm_bw,
        hbm_bytes=hbm_bytes,
        description=description,
    )
    if register:
        register_profile(p)
    return p
