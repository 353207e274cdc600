"""The data kinds a traffic file's ``data`` block names, one module each:
``make(d, gen, dev)`` gives (x_train, x_val) drawn on ``dev`` from the
generator ``gen``, the same sizes for every seed."""
