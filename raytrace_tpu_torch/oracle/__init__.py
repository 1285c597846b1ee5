"""The straight-line CPU oracle (numpy): reference math for goldens."""
