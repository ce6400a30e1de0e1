"""Mean wall of one ``execute`` call (dispatch and synchronize) in the
traced host rounds."""


def read(run):
    h = run.host
    return 1e3 * h["execute_s"] / h["execute_calls"] if h and h["execute_calls"] else None
