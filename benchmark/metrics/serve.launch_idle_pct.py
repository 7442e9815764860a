"""serve.launch_idle_pct: the share of the traced window in which the
device sat idle while the dispatcher was enqueueing a forward (the eval
step's ``model.forward`` span and the ``ops.resize`` spans under it), from
``idle_by_program_span`` (``trace.ProgramTracer``). None without the
program's spans."""

from benchmark.trace import idle_pct


def read(run: dict):
    return idle_pct(run, "model.forward", "ops.resize")
