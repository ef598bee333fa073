"""The evaluation loop of the port (``evaluator.Evaluator``)."""
