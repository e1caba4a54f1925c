"""One driver per traffic mode, named by a traffic file's ``mode``."""
