"""Shared harness code: the manifest, the request loop, the trace reader,
the comparison with the plain reference."""
