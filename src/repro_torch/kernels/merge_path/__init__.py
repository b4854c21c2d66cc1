"""K3 — merge-path merge of sorted row pairs."""
