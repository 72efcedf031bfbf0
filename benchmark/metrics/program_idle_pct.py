"""program_idle_pct: the share of the traced stretch in which the device
ran nothing while the thread issuing to it was inside the program's span
``juicy.corpus_chain`` (one call into the program), in percent
(benchmark/spans.py). ``device_idle_pct`` less this is the idle that the
benchmark's own loop and synchronize leave between calls."""

from benchmark import spans


def read(tr):
    return spans.call_idle_pct(tr)
