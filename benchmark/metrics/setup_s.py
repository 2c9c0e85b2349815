"""Set-up: process start to the first timed step or request (imports,
kernel load or build, model, weights, data, cache fill and warm-up), on the
host's clock."""


def read(rec):
    return rec["setup_s"]
