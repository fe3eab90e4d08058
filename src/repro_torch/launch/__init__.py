"""Command-line entry points of the port (see ``repro.launch``)."""
