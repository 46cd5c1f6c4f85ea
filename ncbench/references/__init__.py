"""Plain references, one module per model family, named by a
configuration's ``reference`` key.  They import nothing of the program."""
