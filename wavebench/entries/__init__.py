"""The calls a cell makes into the program, one module an entry, each with
the check of its answers against the plain reference."""
