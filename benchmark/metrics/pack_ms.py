"""pack_ms: the device windows of the program's spans ``juicy.chain.pack``
(the chain's state packed into kernel form, the constant tables, the
input permuted to [T, 2, B], the output and lane buffers, the lanes'
seed) summed per traced batch, in milliseconds (benchmark/spans.py)."""

from benchmark import spans


def read(tr):
    return spans.phase_ms(tr, "juicy.chain.pack")
