"""The benchmark's drivers, one per entry point of the port; a cell names
its driver (``cells/<workload>.json``)."""
