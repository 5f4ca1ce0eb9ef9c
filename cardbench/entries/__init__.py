"""One module a way of driving the program, named by a traffic file's
``entry``: ``run(ctx)`` builds the program, warms up, measures the
window, reads the traced stretch with ``--trace 1``, and fills
``ctx.compared`` from the reference once the window has closed."""
