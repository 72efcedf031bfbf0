"""finalize_ms: the device window of the program's span ``juicy.finalize``
(``finalize_stream``: the score formulas over every block's lanes and the
serial repetition/fatigue EMA) per traced batch, in milliseconds
(benchmark/spans.py: the host work and the gaps of its small launches
while the device waits are in, the wait behind the queued chain kernels is
not)."""

from benchmark import spans


def read(tr):
    return spans.phase_ms(tr, "juicy.finalize")
