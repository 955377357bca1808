"""Result-frame schema shared by every serialized result.

The PyTorch port carries only the frame schema of `repro.core.engine`
(version stamp, grouped energy columns, the CSV writer); the per-op
engine (`simulate_op` / `simulate_network`) belongs to a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

# Version stamp shared by every serialized result. Bump when a column's
# meaning changes so stale files / downstream parsers fail loud.
RESULT_SCHEMA_VERSION = 1

# Grouped CSV columns for the energy breakdown (pJ).
_ENERGY_GROUPS = {
    "energy_mac_pj": ("mac_random", "mac_wire", "spad_read", "spad_write"),
    "energy_sram_pj": ("sram_read_random", "sram_read_repeat",
                       "sram_write_random", "sram_write_repeat",
                       "sram_idle_kib_cycles", "l2_read", "l2_write"),
    "energy_dram_pj": ("dram_bytes", "noc_byte_hops"),
    "energy_static_pj": ("mac_gated", "pe_leak"),
}

# The one grouped-energy column schema, in this order.
ENERGY_GROUP_COLUMNS = tuple(_ENERGY_GROUPS)


def energy_group_totals(by_action: Optional[Dict[str, float]]
                        ) -> Dict[str, float]:
    """Reduce an action -> pJ mapping onto the grouped energy columns."""
    return {g: sum((by_action or {}).get(a, 0.0) for a in acts)
            for g, acts in _ENERGY_GROUPS.items()}


def write_csv_table(path: str, header: Sequence[str],
                    rows: Sequence[Sequence]) -> None:
    """The shared CSV writer. Floats are written with repr() so a
    read-back parses to the identical value; everything else with str().
    The stdlib csv module escapes labels containing commas or quotes."""
    import csv

    def fmt(v) -> str:
        if isinstance(v, float):         # incl. numpy scalars: cast so
            return repr(float(v))        # numpy-2 reprs don't leak in
        return str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow([fmt(v) for v in r])
