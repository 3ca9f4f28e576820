"""The training units: forward layers, gradient-descent weight owners,
the evaluator and the decision."""
