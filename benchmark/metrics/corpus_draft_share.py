"""Share of live slot-steps whose draft came from the static corpus
(``stats_corpus_steps`` / ``stats_live_steps``), over the window."""


def read(view):
    steps = sum(int(s.live[s.actives].sum()) for s in view.segments)
    if not steps:
        return None
    corpus = sum(int(s.corpus[s.actives].sum()) for s in view.segments)
    return 100.0 * corpus / steps
