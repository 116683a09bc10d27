"""The plain references: one module a kind of configuration, named by
its ``reference`` key.  Plain numpy; nothing here imports the program."""
