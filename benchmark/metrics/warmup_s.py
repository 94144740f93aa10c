"""Start-up: seconds of the server's warm-up searches before ready (its
``warmed up <name> (S s)`` log line)."""

LAYER = "start-up"
SOURCE = "program_span"


def read(run):
    return run.server_times.get("warmup_s")
