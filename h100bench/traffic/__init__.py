"""Traffic kinds: one module per kind, each reading its parameters from the
``mix`` of the cell that names it (``cells/<cell>.json``)."""
