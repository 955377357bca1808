"""A cell cut down to a size the CPU tests can run in seconds: a few
designs, short streams, the first ops of the op list."""
from simbench.harness.registry import ROOT, Cell


def small_cell(name: str, n_ops: int = 6, root=ROOT) -> Cell:
    cell = Cell(name, root)
    mix = cell.mix
    cell.mix = dict(mix, axes=dict(array=[16, 128], sram_mb=[0.25, 8],
                                   dataflow=["ws", "os", "is"]),
                    samples=2, designs_per_pass=6,
                    trace_spec=dict(mix["trace_spec"], cap=512))
    cell.config = dict(cell.config, ops=cell.config["ops"][:n_ops])
    return cell
