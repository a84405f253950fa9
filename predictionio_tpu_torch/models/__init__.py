"""Engine templates of the port (counterpart of ``predictionio_tpu/models``).

``ENGINE_FACTORIES`` maps the template shortnames engine.json may name in
``engineFactory`` to the port's factories: all nine of the JAX package's
templates.
"""

ENGINE_FACTORIES = {
    "recommendation": "predictionio_tpu_torch.models.recommendation.RecommendationEngine",
    "classification": "predictionio_tpu_torch.models.classification.ClassificationEngine",
    "similar_product": "predictionio_tpu_torch.models.similar_product.SimilarProductEngine",
    "universal_recommender":
        "predictionio_tpu_torch.models.universal_recommender.UniversalRecommenderEngine",
    "text": "predictionio_tpu_torch.models.text.TextClassificationEngine",
    "ecommerce": "predictionio_tpu_torch.models.ecommerce.ECommerceEngine",
    "complementary_purchase":
        "predictionio_tpu_torch.models.complementary_purchase.ComplementaryPurchaseEngine",
    "product_ranking":
        "predictionio_tpu_torch.models.product_ranking.ProductRankingEngine",
    "lead_scoring": "predictionio_tpu_torch.models.lead_scoring.LeadScoringEngine",
}
