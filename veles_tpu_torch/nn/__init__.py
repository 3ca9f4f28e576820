"""The training units: forward layers and their gradient-descent twins,
the evaluator, the decision, the input joiner and the Kohonen map."""
