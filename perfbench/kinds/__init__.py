"""The drivers of the traffic kinds: a traffic file's ``kind`` names the
module here that runs its cells (``offline``: generation calls back to
back; ``serve``: open-loop requests through the batcher)."""
