"""Comparison of the port's run logs with the reference's (`compare`)."""
