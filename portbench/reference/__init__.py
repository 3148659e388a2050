"""Plain references, one module a family; none imports the program."""
