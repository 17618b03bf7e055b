"""Stand-in for the reference ``zipvoice`` package (see the parent
directory's ``__init__``): not the reference."""
