"""Transform solvers of the port."""
