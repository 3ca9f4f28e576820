"""Host-side plumbing shared by the port's services."""
