"""Precision@10 over a 3-fold split of app ``MyApp``'s ratings, tuning
the ALS rank (``evaluation.RecommendationEvaluation``)."""
