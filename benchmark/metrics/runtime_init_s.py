"""Start-up: seconds from the server process's start until it held a CUDA
context on every card (``startup.cuda_ready`` in its ``/stats`` at the
window's start): the interpreter, torch's import and the contexts. A
server without the step (older, or on the CPU) reads nothing."""

LAYER = "start-up"
SOURCE = "program_counter"


def read(run):
    return (run.stats0.get("startup") or {}).get("cuda_ready")
