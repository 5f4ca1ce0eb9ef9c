"""Core layer of the port: the plan substrate (``plan``).  The multi-rank
core (groups, segmented containers, the transfer verbs) is later work."""
