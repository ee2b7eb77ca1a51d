"""CUDA graph launches a train step (``cudaGraphLaunch`` runtime calls)
started inside the program's span ``dgtd.train.step``, on any thread: how
often the step replays captured graphs in place of launching its kernels
one by one. Kernel launches are not counted (``train.launches`` counts
those). A dispatch count like ``train.launches``, and lower is better with
it: the two together are what the host dispatches a step. It reads 3 where
the step replays its three graphs and 0 where it runs eagerly, so it is
the check that the graphed path engages, not a figure of merit alone."""

from benchmark.metrics._spans import base_name, calls


def is_graph_launch(name: str) -> bool:
    return base_name(name) == "cudaGraphLaunch"


def read(run):
    return calls(run, "dgtd.train.step", is_graph_launch)
