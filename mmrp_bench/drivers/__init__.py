"""One file per entry point a window drives, named by a traffic file's
``driver``."""
