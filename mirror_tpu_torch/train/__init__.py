"""Checkpoint IO of the port (the train step comes in a later slice)."""
