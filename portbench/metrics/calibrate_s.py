"""Host seconds of ``quantize.calibrate``: the float forward on the card
and the fractions and int8 weights worked out on the host."""


def read(run):
    return run.calibrate_s
