"""Entry points of the port's LM scaffolding (``serve``)."""
