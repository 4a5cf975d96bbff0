"""The benchmark's machinery: it imports nothing of the program at module
level (the program is imported inside `cell.run_cell`)."""
