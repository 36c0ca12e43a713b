"""Movie seconds of every stream completed in the window per second in
which the card was busy (the union of the device's activities over the
window, from a profile of those activities alone:
`model.trace.device_busy_s`): the card's own pace, which the host's does
not set."""


def read(run):
    busy = run.card_busy_s
    return run.movie_s / busy if busy and run.movie_s else None
