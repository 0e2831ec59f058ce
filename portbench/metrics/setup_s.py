"""Set-up: process start to the first timed job (imports, CUDA context, the
kernel library, the capture made and written, one warm-up job)."""


def read(run):
    return run.setup_s
