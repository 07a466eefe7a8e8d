"""Shared column names (reference stdlib/indexing/colnames.py)."""

_INDEX_REPLY = "_pw_index_reply"
_SCORE = "_pw_index_reply_score"
_MATCHED_ID = "_pw_index_reply_id"
_QUERY_ID = "_pw_query_id"
_TOPK = "_pw_topk"
