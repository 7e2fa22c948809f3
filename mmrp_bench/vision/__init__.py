"""The vision towers, one file per ``vision.kind`` of a configuration file."""
