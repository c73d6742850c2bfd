"""Per layer: the StageTimer stage ``postprocess``'s seconds, mean a network
of the traced window."""


def read(run):
    return run.stage_mean("postprocess")
