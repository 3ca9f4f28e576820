"""The fleet's shared pieces the port needs (the chaos roll only)."""
