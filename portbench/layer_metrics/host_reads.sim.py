"""host_reads.sim: the host's reads of device values (the program's
``host_read.*`` spans: each one a wait for the card) per ``env.step`` span
of the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.host_reads_per_step(ctx)
