"""Host seconds of the plan-cache-miss ``Session(...)``: lowering, memory
plan, assembly, and the executor's weights moved and packed."""


def read(run):
    return run.compile_s
