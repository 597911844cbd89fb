"""The route counters of the conv, attention and GroupNorm entry points as
one live mapping, which generation's ``dispatch`` span and both trainers'
``train_step`` spans record the changes of (``profiling.span(...,
counters=ROUTES)``): ``conv_k5``, ``conv_library``, ``conv_copies``
(``ops/conv.py``), ``attn_k2_d32``, ``attn_k2_d64``, ``attn_copies``
(``ops/attention.py``), ``norm_fused``, ``norm_plain``, ``norm_copies``
(``ops/group_norm.py``), and the denoiser's calls by how they ran,
``graph_captures``, ``graph_replays``, ``graph_eager``
(``ops/graph.py``)."""

from collections import ChainMap

from pointreggpt_tpu_torch.ops import attention, conv, graph, group_norm

# a ChainMap lists the last map's keys first: the conv route's lead
ROUTES = ChainMap(graph.ROUTES, group_norm.ROUTES, attention.ROUTES,
                  conv.ROUTES)
