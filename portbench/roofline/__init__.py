"""The least time of each driver's unit of work on the card: one module a
driver, ``least_seconds(unit)`` over :mod:`portbench.peaks`."""
