"""The energy- and circulation-closure probes of the earth model, each
the port of one of the repo's probe scripts, with its arguments and its
output lines:

- ``year_closure`` (``scripts/probe_year_closure.py``): the ocean heat
  closure of every segment over full years;
- ``segment_closure`` (``scripts/probe_segment_closure.py``): one
  segment replayed phase by phase with its forcing in hand, and the
  replayed segment from the same state;
- ``replay_vs_manual`` (``scripts/probe_fused_vs_manual.py``): the
  replayed segment against the same segment taken phase by phase;
- ``energy`` (``scripts/probe_energy.py``): the yearly change of the
  heat reservoirs against the TOA and surface-flux integrals;
- ``toa_decompose`` (``scripts/probe_toa_decompose.py``): every energy
  pathway of a segment against the inventories' changes;
- ``closure`` (``scripts/probe_closure.py``): the ocean's closure with
  one feature off at a time;
- ``moc`` (``scripts/probe_moc.py``): annual-mean overturning,
  streamfunction and velocity extrema, and the annual TOA;
- ``triage`` (``scripts/triage_earth.py``): per-segment extrema until a
  field goes non-finite, then ``debug.bisect_segment``.

Each runs as ``python3 -m uvic_tpu_torch.probes.NAME`` on the card
unless given ``--device cpu``.  Like their scripts they take the earth
model of the repo's tools (``config.tools_earth_config``) and advance
``relyr`` by 5 of 365 days a segment.
"""

from __future__ import annotations

YEAR_DAYS = 365.0      # the probes' year (their scripts' relyr steps)
RHOCP = 4.186e7        # erg/cm^3/K, the audit's ocean heat capacity
CAL_PER_ERG = 2.389e-8


def earth_model(device=None, cfg=None):
    """The probes' coupled earth model (``cfg``, by default
    ``tools_earth_config()``)."""
    from ..config import tools_earth_config
    from ..coupler.driver import CoupledModel
    return CoupledModel(cfg or tools_earth_config(), topo_kind="earth",
                        device=device)


def advance(m, state, nseg=1):
    """``nseg`` segments of ``m`` (replayed on the card), ``relyr``
    advancing by 5 of 365 days each."""
    return m.run(state, nseg, yrlen=YEAR_DAYS)


def segments_per_year(m) -> int:
    return int(round(YEAR_DAYS / m.cfg.time.segtim_days))


def add_device(p):
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
