"""The port benchmark's harness: the library, the server under test, the
traffic generator, the trace reader, the byte model and one run of a cell."""
