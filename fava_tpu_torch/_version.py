"""The port's version: the fava_tpu release whose outputs it reproduces."""

__version__ = "0.4.0"
__version_tuple__ = tuple(__version__.split("."))
