"""The plain reference that decides ``correct``: plain torch, importing
nothing of the program.  ``stencil.py`` forms the operator's products from
the stencil itself; ``solvers/<name>.py`` and ``precons/<name>.py`` are
the Krylov methods and preconditioners a traffic mix's ``reference``
names, found by those names (``precond.py`` puts a preconditioner
together); ``compare.py`` holds each number to its limit."""
