"""Declarative ocean tracer registry (the port's own copy of
``uvic_tpu.coupler.tracers``, same table and order).

The reference composes the tracer count additively from CPP flags
(size.h:28-50) and assigns indices imperatively in `tracer_init`
(UVic_ESCM.F:991-1133).  Here a declarative table is built from the
BgcConfig: each tracer has a name, units, an initial value, and flags
for sources / surface fluxes / virtual fluxes.  Index constants
(itemp, isalt, idic, ...) become attributes looked up by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..config import BgcConfig


@dataclass(frozen=True)
class Tracer:
    name: str
    units: str
    init: float              # uniform initial value (idealized IC)
    has_source: bool = False
    surface_flux: bool = False   # participates in gas/virtual flux exchange


def build_registry(bgc: BgcConfig) -> List[Tracer]:
    """Tracer table in reference order (UVic_ESCM.F tracer_init)."""
    tr = [
        Tracer("temp", "deg C", 10.0),
        Tracer("salt", "(psu-35)/1000", 0.0),
    ]
    if bgc.carbon:
        tr.append(Tracer("dic", "umol cm-3 (= mol m-3)", 2.30, True, True))
        if bgc.carbon_14:
            tr.append(Tracer("c14", "umol cm-3", 2.20, True, True))
    if bgc.alk:
        tr.append(Tracer("alk", "ueq cm-3 (= eq m-3)", 2.40, True, False))
    if bgc.o2:
        tr.append(Tracer("o2", "umol cm-3 (= mol m-3)", 0.20, True, True))
    if bgc.suite in ("npzd", "mobi"):
        tr.append(Tracer("po4", "mmol m-3", 0.5, True, False))
        tr.append(Tracer("phyt", "mmol m-3", 0.14, True, False))
        tr.append(Tracer("zoop", "mmol m-3", 0.014, True, False))
        tr.append(Tracer("detr", "mmol m-3", 1.0e-4, True, False))
        if bgc.suite == "mobi":
            # variable-stoichiometry P quotas (updates/10 size.h:
            # "+2 ! phyt_phos, detr_phos"); init at Redfield P:N=1/16
            tr.append(Tracer("phyt_phos", "mmol P m-3", 0.14 / 16.0,
                             True, False))
            tr.append(Tracer("detr_phos", "mmol P m-3", 1.0e-4 / 16.0,
                             True, False))
        if bgc.nitrogen:
            tr.append(Tracer("no3", "mmol m-3", 5.0, True, False))
            tr.append(Tracer("diaz", "mmol m-3", 0.014, True, False))
    if bgc.suite == "mobi":
        # MOBI 2.x extension (updates/10/source/common/size.h:31-115)
        if bgc.carbon and bgc.carbon_13:
            tr.append(Tracer("dic13", "umol cm-3", 2.30 * 0.011, True,
                             True))
        if bgc.caco3:
            tr.append(Tracer("caco3", "mmol m-3", 1e-3, True, False))
        if bgc.silicon:
            tr.append(Tracer("diat", "mmol m-3", 0.07, True, False))
            # sil/opl carried in mol Si m-3 (mobi.F:2230 k1si "mol
            # m-3"; oplpro in "mol Si m-3 s-1", mobi_src:2692)
            tr.append(Tracer("sil", "mol Si m-3", 0.03, True, False))
            tr.append(Tracer("opl", "mol Si m-3", 1e-6, True, False))
        if bgc.nitrogen:
            tr.append(Tracer("dop", "mmol m-3", 0.01, True, False))
            tr.append(Tracer("don", "mmol m-3", 0.2, True, False))
        if bgc.iron:
            # Fe in mmol Fe m-3 (kfemin=0.04e-3, lig=1e-3 in mobi.F
            # iron defaults are mmol-based); 0.6 nM typical interior
            tr.append(Tracer("dfe", "mmol Fe m-3", 0.6e-3, True,
                             False))
            tr.append(Tracer("detrfe", "mmol Fe m-3", 1e-8, True,
                             False))
        if bgc.nitrogen and bgc.nitrogen_15:
            for name, base in (("din15", 5.0), ("phytn15", 0.14),
                               ("zoopn15", 0.014), ("detrn15", 1e-4),
                               ("diazn15", 0.014), ("don15", 0.2)):
                tr.append(Tracer(name, "mmol m-3", base * 0.0036765,
                                 True, False))
            if bgc.silicon:
                tr.append(Tracer("diatn15", "mmol m-3",
                                 0.07 * 0.0036765, True, False))
        if bgc.carbon and bgc.carbon_13:
            # organic c13 pools carry mol C m-3 = pool_N * redctn * R
            # (rt*13 ratio definitions, mobi.F:2635-2665: rtphytc13 =
            # phytc13/(phyt*redctn) with redctn ~ 7.1e-3 mol C/mmol N)
            rc = 7.1e-3 * 0.011
            for name, base in (("phytc13", 0.14), ("zoopc13", 0.014),
                               ("detrc13", 1e-4)):
                tr.append(Tracer(name, "mol C m-3", base * rc,
                                 True, False))
            if bgc.caco3:
                # caco3c13/caco3 is a direct ratio (mobi.F:2657)
                tr.append(Tracer("caco3c13", "mmol m-3", 1e-3 * 0.011,
                                 True, False))
            if bgc.silicon:
                tr.append(Tracer("diatc13", "mol C m-3",
                                 0.07 * rc, True, False))
            if bgc.nitrogen:
                tr.append(Tracer("diazc13", "mol C m-3",
                                 0.014 * rc, True, False))
                tr.append(Tracer("doc13", "mol C m-3", 0.2 * rc,
                                 True, False))
        if bgc.pa_th:
            tr.append(Tracer("pa231", "dpm m-3", 1e-3, True, False))
            tr.append(Tracer("th230", "dpm m-3", 1e-3, True, False))
    if bgc.cfc:
        # O_cfcs_data_transient (gasbc.F:414-467): purely passive,
        # forced by the hemispheric atmospheric history
        tr.append(Tracer("cfc11", "mol m-3", 0.0, True, True))
        tr.append(Tracer("cfc12", "mol m-3", 0.0, True, True))
    return tr


class TracerIndex:
    """Name -> index lookup (the itemp/isalt/... registry)."""

    def __init__(self, tracers: List[Tracer]):
        self.tracers = tracers
        self.names = [t.name for t in tracers]
        for i, t in enumerate(tracers):
            setattr(self, "i" + t.name, i)
        self.nt = len(tracers)
        self.nsrc = sum(t.has_source for t in tracers)
        self.source_idx = [i for i, t in enumerate(tracers) if t.has_source]

    def index(self, name: str) -> Optional[int]:
        try:
            return self.names.index(name)
        except ValueError:
            return None

    def __contains__(self, name):
        return name in self.names

    def __getitem__(self, name):
        return self.names.index(name)
