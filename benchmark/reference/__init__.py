"""The plain reference of the benchmark's cells: torch in the dtype handed in,
nothing of the program."""
