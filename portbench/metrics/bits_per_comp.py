"""bits_per_comp: 8 × the bytes of the component stream in the arrays the
program placed, over the corpus's nonzeros. The stream is the first of
these pairs of array names that the placed arrays hold."""

#: (control, data) arrays of the component stream: block form, row form
STREAMS = (("ctrl", "data"), ("ctrl_rows", "data_rows"))


def read(rec):
    placed, nnz = rec["placed_bytes"], rec["stats"]["nnz"]
    for names in STREAMS:
        if all(n in placed for n in names) and nnz:
            return 8 * sum(placed[n] for n in names) / nnz
    return None
