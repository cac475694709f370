"""Window time outside every toolbox slot's span, per pair: the executor's
chunking, gates, ledger and PNG writes (`runtime/executor.py`, `core/ledger.py`,
`core/png.py`)."""

from portbench.harness.readers import outside_ms_per_unit

NAME = "executor_ms_per_pair.factory"
UNIT = "ms"
LAYER = "executor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return outside_ms_per_unit(r)
