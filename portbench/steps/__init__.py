"""The step paths a traffic file's ``step`` names, one module each:
``fns(model)`` gives the ``Trainer``'s keyword arguments of that path."""
