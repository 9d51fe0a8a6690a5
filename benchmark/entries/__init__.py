"""The entries a cell can drive, one module each, named by the ``entry``
of its workload file."""
