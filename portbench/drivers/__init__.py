"""One driver a traffic kind: set-up, the measured window and the check."""
