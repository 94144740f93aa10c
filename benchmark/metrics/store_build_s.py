"""Start-up: seconds the server took to build the library's store on the
card (its ``uploaded <name> ... (S s)`` log line)."""

LAYER = "start-up"
SOURCE = "program_span"


def read(run):
    return run.server_times.get("store_build_s")
