"""Stat spec combinator parser (stats/Stat.scala:1-388).

Port of ``geomesa_tpu/stats/parser.py``.

Grammar subset:
    stat     := single (';' single)*        -- SeqStat when >1
    single   := Count() | MinMax(a) | Enumeration(a) | TopK(a[,cap])
              | Histogram(a,bins,lo,hi) | Frequency(a[,width])
              | DescriptiveStats(a) | Z3Histogram(geom,dtg,period,length)
              | Z3Frequency(geom,dtg[,period[,precision[,width]]])
              | GroupBy(a, single)          -- nested sub-stat per key
"""

from __future__ import annotations

import re
from typing import List

from geomesa_tpu_torch.stats.sketches import (
    CountStat,
    DescriptiveStats,
    EnumerationStat,
    Frequency,
    GroupByStat,
    Histogram,
    MinMax,
    SeqStat,
    Stat,
    TopK,
    Z3FrequencyStat,
    Z3HistogramStat,
)

_CALL = re.compile(r"\s*([A-Za-z0-9_]+)\s*\(([^)]*)\)\s*$")


def _args(raw: str) -> List[str]:
    return [a.strip().strip("'\"") for a in raw.split(",") if a.strip()] if raw.strip() else []


def parse_stat(spec: str) -> Stat:
    parts = [p for p in spec.split(";") if p.strip()]
    stats: List[Stat] = []
    for part in parts:
        # GroupBy nests a full sub-stat spec -> balanced-paren special case
        g = re.match(
            r"\s*GroupBy\s*\(\s*['\"]?([A-Za-z0-9_]+)['\"]?\s*,\s*(.+)\)\s*$",
            part,
            re.IGNORECASE,
        )
        if g:
            stats.append(GroupByStat(g.group(1), parse_stat(g.group(2))))
            continue
        m = _CALL.match(part)
        if not m:
            raise ValueError(f"bad stat spec: {part!r}")
        name, args = m.group(1).lower(), _args(m.group(2))
        if name == "count":
            stats.append(CountStat())
        elif name == "minmax":
            stats.append(MinMax(args[0]))
        elif name == "enumeration":
            stats.append(EnumerationStat(args[0]))
        elif name == "topk":
            stats.append(TopK(args[0], int(args[1]) if len(args) > 1 else 1000))
        elif name == "histogram":
            stats.append(Histogram(args[0], int(args[1]), float(args[2]), float(args[3])))
        elif name == "frequency":
            stats.append(Frequency(args[0], int(args[1]) if len(args) > 1 else 1024))
        elif name == "descriptivestats":
            stats.append(DescriptiveStats(args[0]))
        elif name == "z3frequency":
            stats.append(
                Z3FrequencyStat(
                    args[0],
                    args[1],
                    args[2] if len(args) > 2 else "week",
                    int(args[3]) if len(args) > 3 else 25,
                    int(args[4]) if len(args) > 4 else 1024,
                )
            )
        elif name == "z3histogram":
            stats.append(
                Z3HistogramStat(
                    args[0],
                    args[1],
                    args[2] if len(args) > 2 else "week",
                    int(args[3]) if len(args) > 3 else 1024,
                )
            )
        else:
            raise ValueError(f"unknown stat: {name}")
    if len(stats) == 1:
        return stats[0]
    return SeqStat(stats)
