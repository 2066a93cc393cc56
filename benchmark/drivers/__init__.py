"""One driver a traffic kind: `run(ctx)` sets the cell up, measures the
window, checks what the window's path produced against the reference."""
