"""Model workflows: StandardWorkflow and the MLP family."""
