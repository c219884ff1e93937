"""Seconds from the process's start to the barrier that opens the window:
starting the interpreter and CUDA, making the inputs, building or
loading the kernels, and warming every input through every client."""


def read(ctx):
    return ctx.setup_s
