"""Model workflows: StandardWorkflow, the MLP family, AlexNet and the
Kohonen SOM."""
